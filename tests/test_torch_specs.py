"""The port's cell builder (``repro_torch.launch.specs``) against the
reference's (``repro.launch.specs``).

Every (arch, cell) of ``ASSIGNED`` on a 4 x 2 and a 16 x 16 (data,
model) mesh: the step name, the arguments' shapes and dtypes, the in /
out specs leaf by leaf (keypaths included), the donated arguments and
``model_flops`` (exactly) equal the reference's, and the same cells
raise ``SkippedCell``; so do the MoE dispatch dicts of
``make_moe_shardings``. The reference's side runs in one subprocess
with 256 fake host devices (its ``make_moe_shardings`` and
``make_halo_ops`` need a real mesh); the port's builds on duck-typed
meshes, on meta tensors.

The sampled-subgraph step (``graph_minibatch``) at smoke size: its loss
and its gradient (the first moment after one AdamW step, ``(1 - b1)
g``) within ``rtol=1e-5, atol=1e-6`` of the reference cell's step on
the same 4 subgraphs; and on 4 gloo ranks of a (2, 2) mesh, each
holding its data rank's subgraph, of the one-process step on both.
"""
import concurrent.futures
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import specs
from repro_torch.launch.local import run_ranks
from repro_torch.models import gnn as tgnn
from repro_torch.train.optimizer import AdamW
from repro_torch.tree import flatten_with_path, tree_leaves, tree_map

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_serving_workers as W  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
MESHES = {"4x2": (4, 2), "16x16": (16, 16)}
CELLS = [(a, c.name) for a in ASSIGNED for c in get_arch(a).shapes]
MOE_ARCHS = [a for a in ASSIGNED if getattr(get_arch(a).config, "moe",
                                            False)]

REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import ASSIGNED, get_arch
    from repro.launch import specs

    def entry(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else list(e)
        return e

    def flat(tree, leaf):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]
        return [["/".join(str(k) for k in path), leaf(x)]
                for path, x in leaves]

    def spec(s):
        return [entry(e) for e in s]

    def struct(x):
        return [list(x.shape), str(np.dtype(x.dtype))]

    out = {}
    for name, shape in json.loads(sys.argv[1]).items():
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             devices=jax.devices()[:shape[0] * shape[1]])
        for arch in ASSIGNED:
            a = get_arch(arch)
            for cell in a.shapes:
                key = f"{name}/{arch}/{cell.name}"
                try:
                    prog = specs.build_cell(arch, cell.name, mesh)
                except specs.SkippedCell as e:
                    out[key] = {"skipped": str(e)}
                    continue
                out[key] = dict(
                    step_name=prog.step_name, args=flat(prog.args, struct),
                    in_specs=flat(prog.in_specs, spec),
                    out_specs=flat(prog.out_specs, spec),
                    donate=list(prog.donate), model_flops=prog.model_flops)
            if getattr(a.config, "moe", False):
                ms = specs.make_moe_shardings(a.config, mesh)
                out[f"{name}/{arch}/moe"] = (
                    {"ep": [list(ms["dp"]), ms["mdl"]]} if "ep_mesh" in ms
                    else {k: spec(v.spec) for k, v in ms.items()})
    json.dump(out, sys.stdout)
""")


def _mesh(shape):
    d = dict(zip(("data", "model"), shape))
    return types.SimpleNamespace(shape=d, axis_names=tuple(d))


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _flat(tree, leaf):
    return [[path, leaf(x)] for path, x in flatten_with_path(tree)]


def _spec(s):
    return [_entry(e) for e in s]


def _struct(x):
    assert x.device.type == "meta"
    return [list(x.shape), str(x.dtype).replace("torch.", "")]


def port_cell(arch, cell, mesh) -> dict:
    """The port's cell in the reference script's JSON form."""
    try:
        prog = specs.build_cell(arch, cell, mesh)
    except specs.SkippedCell as e:
        return {"skipped": str(e)}
    return json.loads(json.dumps(dict(
        step_name=prog.step_name, args=_flat(prog.args, _struct),
        in_specs=_flat(prog.in_specs, _spec),
        out_specs=_flat(prog.out_specs, _spec), donate=list(prog.donate),
        model_flops=prog.model_flops)))


@pytest.fixture(scope="module")
def ref_cells():
    """Every reference cell on both meshes, from one subprocess with 256
    fake host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                          json.dumps(MESHES)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,cell", CELLS)
def test_cell_equals_the_references(arch, cell, mesh, ref_cells):
    got = port_cell(arch, cell, _mesh(MESHES[mesh]))
    want = ref_cells[f"{mesh}/{arch}/{cell}"]
    if "skipped" in want:
        assert got == want
        return
    for key in ("step_name", "donate", "model_flops", "args", "in_specs",
                "out_specs"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_shardings_equal_the_references(arch, mesh, ref_cells):
    ms = specs.make_moe_shardings(get_arch(arch).config,
                                  _mesh(MESHES[mesh]))
    got = ({"ep": [list(ms["dp"]), ms["mdl"]]} if "ep_mesh" in ms
           else {k: _spec(v.spec) for k, v in ms.items()})
    assert json.loads(json.dumps(got)) == ref_cells[f"{mesh}/{arch}/moe"]


def test_cells_hold_no_storage():
    """A full-config cell's arguments are meta tensors (the 46.7 B
    parameters of mixtral, the 33.8 M FM rows)."""
    for arch, cell in (("mixtral-8x7b", "train_4k"), ("fm", "train_batch")):
        prog = specs.build_cell(arch, cell, _mesh((16, 16)))
        assert all(x.device.type == "meta" for x in tree_leaves(prog.args))


# ------------------------------------------------- sampled subgraphs -----
MB_CELL = ShapeCell("minibatch_smoke", "graph_minibatch", n_nodes=100,
                    n_edges=400, batch_nodes=8, fanout=(2, 2), d_feat=8)
MB_ARCHS = ("gatedgcn", "meshgraphnet")


def _mb_arch(arch):
    a = get_arch(arch)
    return dataclasses.replace(a, config=a.smoke)


@functools.lru_cache(maxsize=None)
def mb_inputs(arch, n_sub):
    """(numpy params from the port's seeded init, numpy AdamW state,
    numpy batch of ``n_sub`` subgraphs at the cell's padded sizes)."""
    cfg = get_arch(arch).smoke
    init = tgnn.gatedgcn_init if arch == "gatedgcn" else \
        tgnn.meshgraphnet_init
    params = init(cfg, MB_CELL.d_feat, 4, torch.Generator().manual_seed(0),
                  device="cpu")
    state = AdamW(lr=1e-3).init(params)
    prog = specs.build_gnn_cell(_mb_arch(arch), MB_CELL, _mesh((n_sub, 1)))
    rng = np.random.default_rng(n_sub)
    batch = {}
    for key, x in prog.args[2].items():
        shape = tuple(x.shape)
        n = prog.args[2]["node_feat"].shape[1]
        if key in ("senders", "receivers"):
            batch[key] = rng.integers(0, n, shape).astype(np.int32)
        elif key == "labels":
            batch[key] = rng.integers(0, cfg.n_classes, shape).astype(
                np.int32)
        elif key == "node_mask":
            batch[key] = rng.random(shape) < 0.5
        else:
            batch[key] = rng.standard_normal(shape).astype(np.float32)
    np_ = functools.partial(tree_map, lambda v: v.numpy())
    return np_(params), np_(state), batch


def port_minibatch(arch, shape):
    """(loss, first moment leaves) of the port's cell step given every
    subgraph, on a duck-typed ``shape`` mesh."""
    from repro_torch.convert import tree_from_numpy

    params, state, batch = mb_inputs(arch, shape[0])
    prog = specs.build_gnn_cell(_mb_arch(arch), MB_CELL, _mesh(shape))
    _, s, aux = prog.fn(tree_from_numpy(params, "cpu"),
                        tree_from_numpy(state, "cpu"),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(aux["loss"]), [v.numpy() for v in tree_leaves(s.mu)]


@pytest.fixture(scope="module")
def mb_ranks(tmp_path_factory):
    """The cell step on 4 gloo ranks of a (2, 2) mesh, each given its
    data rank's subgraph: {arch: [each rank's result]}, started on a
    thread."""
    todo = [("minibatch_worker", ((2, 2), _mb_arch(a), MB_CELL)
             + mb_inputs(a, 2)) for a in MB_ARCHS]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_ranks, W.jobs, 4, todo, backend="gloo",
                      store_dir=str(tmp_path_factory.mktemp("mb4")),
                      timeout_s=180.0)
    yield fut
    pool.shutdown(wait=True)


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("arch", MB_ARCHS)
def test_minibatch_step_matches_the_references(arch, mb_ranks):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_get_arch
    from repro.launch import specs as jspecs
    from repro.train.optimizer import AdamW as JAdamW

    params, _, batch = mb_inputs(arch, 4)
    ja = jax_get_arch(arch)
    ja = dataclasses.replace(ja, config=ja.smoke)
    jprog = jspecs.build_gnn_cell(ja, MB_CELL, _mesh((4, 2)))
    jp = jax.tree.map(jnp.asarray, params)
    _, js, jaux = jax.jit(jprog.fn)(
        jp, JAdamW(lr=1e-3).init(jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    want = (float(jaux["loss"]),
            [np.asarray(v) for v in jax.tree_util.tree_leaves(js.mu)])
    _close(port_minibatch(arch, (4, 2)), want)


@pytest.mark.parametrize("arch", MB_ARCHS)
def test_minibatch_step_on_four_ranks_matches_one_process(arch, mb_ranks):
    """Each rank's share of the loss and gradients summed over the data
    axes: every rank holds the one-process step's loss and moment."""
    want = port_minibatch(arch, (2, 2))
    for rank in mb_ranks.result():
        r = rank[MB_ARCHS.index(arch)]
        _close((r["loss"], r["mu"]), want)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    store = tmp_path_factory.mktemp("specs1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_full_graph_cell_on_one_rank_is_the_unsharded_step(one_rank):
    """gatedgcn-smoke's full-graph cell on the (1, 1) mesh (its halo ops
    made at the first call): two steps ``torch.equal`` to
    ``make_gnn_train_step`` without them."""
    from repro_torch.convert import tree_from_numpy
    from repro_torch.train.steps import make_gnn_train_step

    cell = dataclasses.replace(MB_CELL, kind="graph_full")
    prog = specs.build_gnn_cell(_mb_arch("gatedgcn"), cell, one_rank)
    params, state, batch = mb_inputs("gatedgcn", 1)
    flat = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in prog.args[2].items()}
    plain = make_gnn_train_step(get_arch("gatedgcn").smoke, AdamW(lr=1e-3),
                                remat=True)
    outs = []
    for step in (plain, prog.fn):
        p, s = tree_from_numpy(params, "cpu"), tree_from_numpy(state, "cpu")
        losses = []
        for _ in range(2):
            p, s, aux = step(p, s, flat)
            losses.append(aux["loss"])
        outs.append(losses + tree_leaves(p))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
