"""The port's sharding rules and placement against the reference.

Host parity, in this process and with no devices: the spec trees of
``repro_torch.distributed.sharding`` equal ``repro.distributed.sharding``'s
leaf for leaf on duck-typed meshes (an object with a ``.shape`` dict and
``.axis_names``, which both packages' rules accept), over the
reference's ``jax.eval_shape`` trees at full config (and the port's own
parameter trees carry the same keypaths). One subprocess with 8 fake
host devices holds ``local_slice`` against JAX's ``devices_indices_map``.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jax_get_arch
from repro.distributed import halo as jhalo
from repro.distributed import sharding as jshd
from repro.models import dimenet as jdimenet
from repro.models import fm as jfm
from repro.models import gnn as jgnn
from repro.models import transformer as jT
from repro_torch.configs import get_arch
from repro_torch.distributed import halo as thalo
from repro_torch.distributed import sharding as tshd
from repro_torch.models import gnn as tgnn
from repro_torch.models import transformer as tT
from repro_torch.tree import flatten_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"4x2": {"data": 4, "model": 2}, "16x16": {"data": 16,
                                                    "model": 16}}
LM_ARCHS = ("granite-8b", "qwen3-moe-235b-a22b", "mixtral-8x7b")


def _mesh(name):
    shape = MESHES[name]
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


def _ref_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [("/".join(str(k) for k in path), tuple(s)) for path, s in flat]


def _port_flat(tree):
    return [(path, tuple(s)) for path, s in flatten_with_path(tree)]


def _lm_structs(arch):
    cfg = jax_get_arch(arch).config
    return jax.eval_shape(lambda k: jT.init_params(cfg, k),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_specs_equal_the_references(arch, mesh):
    structs = _lm_structs(arch)
    m = _mesh(mesh)
    want = _ref_flat(jshd.lm_param_specs(jax_get_arch(arch).config, m,
                                         structs))
    got = _port_flat(tshd.lm_param_specs(get_arch(arch).config, m,
                                         structs))
    assert got == want
    if arch == "granite-8b":
        # every large weight is sharded (the reference's FSDP check,
        # tests/test_distributed.py; a MoE router stays replicated)
        shapes = [leaf.shape for leaf in jax.tree_util.tree_leaves(structs)]
        for (path, spec), shape in zip(got, shapes):
            if np.prod(shape) > 1e6:
                assert any(ax is not None for ax in spec), (path, spec)


@pytest.mark.parametrize("strategy", ["fsdp", "tp_fsdp"])
def test_lm_strategies_equal_the_references(strategy):
    structs = _lm_structs("granite-8b")
    m = _mesh("4x2")
    cfg, tcfg = (jax_get_arch("granite-8b").config,
                 get_arch("granite-8b").config)
    want = _ref_flat(jshd.lm_param_specs(cfg, m, structs, strategy))
    got = _port_flat(tshd.lm_param_specs(tcfg, m, structs, strategy))
    assert got == want


def test_port_lm_tree_has_the_references_keypaths():
    """The port's own parameter tree (smoke size) holds the reference's
    keypaths and shapes, so the rules meet the same paths."""
    cfg = get_arch("qwen3-moe-235b-a22b").smoke
    port = tT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.eval_shape(lambda k: jT.init_params(
        jax_get_arch("qwen3-moe-235b-a22b").smoke, k), jax.random.PRNGKey(0))
    got = [(p, tuple(v.shape)) for p, v in flatten_with_path(port)]
    want = [("/".join(str(k) for k in path), tuple(v.shape)) for path, v
            in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert got == want
    m = _mesh("4x2")
    assert (_port_flat(tshd.lm_param_specs(cfg, m, port))
            == _ref_flat(jshd.lm_param_specs(
                jax_get_arch("qwen3-moe-235b-a22b").smoke, m, ref)))


def _gnn_structs(arch, d_feat=1433):
    cfg = jax_get_arch(arch).config
    key = jax.random.PRNGKey(0)
    if arch == "gatedgcn":
        return jax.eval_shape(functools.partial(jgnn.gatedgcn_init, cfg,
                                                d_feat, 4), key)
    if arch == "dimenet":
        return jax.eval_shape(functools.partial(jdimenet.dimenet_init, cfg),
                              key)
    return jax.eval_shape(functools.partial(jfm.fm_init, cfg), key)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["fm", "gatedgcn", "dimenet"])
def test_param_specs_for_equal_the_references(arch, mesh):
    structs = _gnn_structs(arch)
    m = _mesh(mesh)
    want = jshd.param_specs_for(jax_get_arch(arch).config, m, structs)
    got = tshd.param_specs_for(get_arch(arch).config, m, structs)
    assert _port_flat(got) == _ref_flat(want)
    assert (_port_flat(tshd.opt_state_specs(got))
            == _ref_flat(jshd.opt_state_specs(want)))


def test_port_gatedgcn_tree_has_the_references_keypaths():
    cfg = get_arch("gatedgcn").smoke
    port = tgnn.gatedgcn_init(cfg, 8, 4, torch.Generator().manual_seed(0),
                              "cpu")
    ref = jax.eval_shape(functools.partial(
        jgnn.gatedgcn_init, jax_get_arch("gatedgcn").smoke, 8, 4),
        jax.random.PRNGKey(0))
    assert ([(p, tuple(v.shape)) for p, v in flatten_with_path(port)]
            == [("/".join(str(k) for k in path), tuple(v.shape))
                for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]])


BATCH_KEYS = ("senders", "receivers", "node_feat", "edge_feat", "labels",
              "node_mask", "z", "pos", "edge_src", "edge_dst", "mol_id",
              "energy", "trip_kj", "trip_ji", "n_mols", "other")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_equal_the_references(mesh):
    m = _mesh(mesh)
    for name in ("lm_batch_specs", "lm_cache_specs", "fm_batch_specs"):
        want = getattr(jshd, name)(m)
        got = getattr(tshd, name)(m)
        assert _port_flat(got) == _ref_flat(want), name
    for name in ("graph_batch_specs", "minibatch_specs"):
        want = getattr(jshd, name)(m, BATCH_KEYS)
        got = getattr(tshd, name)(m, BATCH_KEYS)
        assert _port_flat(got) == _ref_flat(want), name


def test_undivided_dims_are_replicated_as_in_the_reference():
    """``_tree_specs`` drops an axis that does not divide its dimension."""
    m = _mesh("4x2")
    tree = {"a": jax.ShapeDtypeStruct((6, 8), np.float32),
            "b": jax.ShapeDtypeStruct((8, 3), np.float32),
            "c": jax.ShapeDtypeStruct((16,), np.float32)}
    rules = [(r"\['a'\]", ("data", "model")), (r"\['b'\]", ("data",
                                                              "model")),
             (r"\['c'\]", (("data", "model"),))]
    want = jshd._tree_specs(tree, [(p, JP(*s)) for p, s in rules], m)
    got = tshd._tree_specs(tree, [(p, tshd.P(*s)) for p, s in rules], m)
    assert _port_flat(got) == _ref_flat(want)
    assert _port_flat(got) == [("['a']", (None, "model")),
                               ("['b']", ("data", None)),
                               ("['c']", (("data", "model"),))]


def test_spec_normalizes_as_jax():
    for entries in [(("data",), None), ((), "model"),
                    (("data", "model"), None, "model"), ()]:
        assert tuple(tshd.P(*entries)) == tuple(JP(*entries))


# specs whose local slices are held against devices_indices_map: a dim
# over two axes (data-major), two dims over one axis each, and the spec
# _tree_specs degrades to replication on dimension 0 (6 over 4 ranks)
SLICE_CASES = [((16, 3), (("data", "model"), None)),
               ((2, 8, 6), (None, "data", "model")),
               ((6, 8), (None, "model"))]


def test_local_slices_equal_jax_devices_indices_map():
    code = textwrap.dedent("""
        import os, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = jax.make_mesh((4, 2), ("data", "model"))
        cases = json.loads(%r)
        out = []
        for shape, spec in cases:
            spec = [tuple(e) if isinstance(e, list) else e for e in spec]
            m = NamedSharding(mesh, P(*spec)).devices_indices_map(
                tuple(shape))
            out.append([[[[s.start or 0, shape[k] if s.stop is None
                           else s.stop] for k, s in enumerate(m[dev])]
                         for dev in row] for row in mesh.devices])
        print(json.dumps(out))
        """) % json.dumps([[list(s), list(p)] for s, p in SLICE_CASES])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    m = _mesh("4x2")
    for (shape, spec), grid in zip(SLICE_CASES, want):
        for i in range(4):
            for j in range(2):
                got = tshd.local_slice(tshd.P(*spec), shape, m, i * 2 + j)
                assert [[s.start, s.stop] for s in got] == grid[i][j], (
                    shape, spec, i, j)
    # the degraded case is what _tree_specs makes of P("data", "model")
    deg = tshd.fit_spec(tshd.P("data", "model"), (6, 8), m)
    assert tuple(deg) == SLICE_CASES[2][1]


def test_shard_tree_cuts_each_rank_its_block():
    m = _mesh("4x2")
    full = {"w": torch.arange(64.).reshape(16, 4),
            "b": torch.arange(8.)}
    specs = {"w": tshd.P(("data", "model"), None), "b": tshd.P()}
    blocks = [tshd.shard_tree(full, specs, m, rank=r) for r in range(8)]
    assert torch.equal(torch.cat([b["w"] for b in blocks]), full["w"])
    assert all(torch.equal(b["b"], full["b"]) for b in blocks)
    named = tshd.to_named(specs, m)
    assert named["w"].local_slice((16, 4), 5) == (slice(10, 12),
                                                 slice(0, 4))


def test_with_sharding_constraint_checks_and_narrows():
    one = types.SimpleNamespace(shape={"data": 1, "model": 1},
                                axis_names=("data", "model"))
    two = _mesh("4x2")
    x = torch.randn(4, 6, 8)
    ok = tshd.NamedSharding(one, tshd.P("data", None, "model"))
    assert tshd.with_sharding_constraint(x, ok) is x
    with pytest.raises(ValueError):
        tshd.with_sharding_constraint(x, tshd.NamedSharding(
            one, tshd.P(None, None, None, "data")))
    with pytest.raises(ValueError):
        tshd.with_sharding_constraint(x, tshd.NamedSharding(
            one, tshd.P("pod")))
    # over several ranks the block moves by collectives
    # (tests/test_torch_tp.py); a mesh without process groups has none
    with pytest.raises(ValueError, match="process groups"):
        tshd.with_sharding_constraint(x, tshd.NamedSharding(
            two, tshd.P("data")))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_validate_locality_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    n, m = 1024, 4096
    pos = np.arange(m) * n // m
    idx = np.clip(pos + rng.integers(-300, 300, m), 0, n - 1)
    for shards in (4, 8, 16):
        assert (thalo.validate_locality(idx, pos, n, shards)
                == jhalo.validate_locality(idx, pos, n, shards))
