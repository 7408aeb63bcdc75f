"""The FM cells of ``launch.specs.build_fm_cell`` on meshes of several
ranks (gloo process groups on the CPU), in both layouts of their tables
(``distributed.rows``).

Two smoke-sized configs (FM-smoke's 4-wide embeddings over 24 fields,
so that the retrieval cell's 20 user fields leave 4 candidate fields):
``ROWS`` has 296 rows, which divide over 4 ranks, so ``fm_param_specs``
splits them over every axis on (2, 2), (1, 4) and (4, 1); ``WHOLE``
has 294 rows, which do not, so on (2, 2) the tables are whole on every
rank (the reference's ``fit_specs``, as FM's 32 580 500 rows on
16 x 16). One spawn of 4 ranks (``tests/_torch_fm_workers.py``) runs
every case: two AdamW train steps of the cell, the train step's
gradients, the serve scores and the retrieval scores, each gathered and
held within ``rtol=1e-5, atol=1e-6`` of the same steps in one process
on whole tensors, and the loss and gradients within that tolerance of
the reference's ``fm_loss`` under ``jax.value_and_grad``, the scores of
its ``fm_score`` and ``retrieval_score``. The row-sharded lookup equals
the one-process lookup bit for bit. At world size 1 (in this process)
the cells are ``torch.equal`` to the unsharded steps.
"""
import concurrent.futures
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import tree_from_numpy
from repro_torch.launch import specs
from repro_torch.launch.local import run_ranks
from repro_torch.models import fm as tfm
from repro_torch.train import steps as tsteps
from repro_torch.train.optimizer import AdamW
from repro_torch.tree import tree_leaves, tree_map

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_fm_workers as W  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT_S = 180.0
BATCH, N_CAND, N_USER, STEPS = 8, 1024, 20, 2
_SMOKE = get_arch("fm").smoke
CFGS = {
    "rows": dataclasses.replace(_SMOKE, n_sparse=24,
                                vocab_sizes=(12,) * 23 + (20,)),
    "whole": dataclasses.replace(_SMOKE, n_sparse=24,
                                 vocab_sizes=(12,) * 23 + (18,)),
}
CASES = {"rows_2x2": ((2, 2), "rows"), "rows_1x4": ((1, 4), "rows"),
         "rows_4x1": ((4, 1), "rows"), "whole_2x2": ((2, 2), "whole")}


@functools.lru_cache(maxsize=None)
def inputs(key):
    """(numpy params from the port's seeded init, a numpy click batch,
    one user's flat ids, the candidates' flat ids)."""
    cfg = CFGS[key]
    params = tree_map(lambda v: v.numpy(), tfm.fm_init(
        cfg, torch.Generator().manual_seed(3), "cpu"))
    rng = np.random.default_rng(4)
    vocab = np.asarray(cfg.vocab_sizes)
    idx = (rng.random((BATCH, cfg.n_sparse)) * vocab).astype(np.int32)
    labels = (rng.random(BATCH) < 0.5).astype(np.float32)
    raw = (rng.random((N_CAND, cfg.n_sparse)) * vocab).astype(np.int32)
    flat = (raw + tfm.field_offsets(cfg)[None, :]).astype(np.int32)
    return (params, {"idx": idx, "labels": labels}, flat[0, :N_USER].copy(),
            flat[:, N_USER:].copy())


def one_process(key) -> dict:
    """The same steps on whole tensors in this process."""
    cfg = CFGS[key]
    params, batch, user, cand = inputs(key)
    p = tree_from_numpy(params, "cpu")
    b = tree_from_numpy(batch, "cpu")
    step = tsteps.make_fm_train_step(cfg, AdamW(lr=1e-3))
    s, losses = AdamW(lr=1e-3).init(p), []
    for _ in range(STEPS):
        p, s, aux = step(p, s, b)
        losses.append(float(aux["loss"]))
    p0 = tree_from_numpy(params, "cpu")
    loss, grads = tsteps.value_and_grad(
        lambda q, bb: tfm.fm_loss(q, bb["idx"], bb["labels"], cfg), p0, b)
    return {"losses": losses, "params": tree_map(lambda t: t.numpy(), p),
            "grads": tree_map(lambda t: t.numpy(), grads),
            "grad_loss": float(loss),
            "serve": tsteps.make_fm_serve_step(cfg)(p0, b).numpy(),
            "retrieval": tsteps.make_fm_retrieval_step(cfg, N_USER)(
                p0, torch.from_numpy(user), torch.from_numpy(cand)).numpy()}


def reference(key) -> dict:
    """The reference's loss and gradient (``jax.value_and_grad`` of its
    ``fm_loss``), scores and retrieval scores."""
    import jax
    import jax.numpy as jnp
    from repro.models import fm as jfm

    cfg = CFGS[key]
    params, batch, user, cand = inputs(key)
    jp = jax.tree.map(jnp.asarray, params)
    loss, grads = jax.value_and_grad(jfm.fm_loss)(
        jp, jnp.asarray(batch["idx"]), jnp.asarray(batch["labels"]), cfg)
    return {"grad_loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads),
            "serve": np.asarray(jfm.fm_score(jp, jnp.asarray(batch["idx"]),
                                             cfg)),
            "retrieval": np.asarray(jfm.retrieval_score(
                jp, jnp.asarray(user), jnp.asarray(cand), cfg, N_USER))}


@pytest.fixture(scope="module")
def pending(tmp_path_factory):
    """The 4-rank spawn of every case, started on a thread."""
    todo = []
    for shape, key in CASES.values():
        params, batch, user, cand = inputs(key)
        todo.append(("fm_case", (shape, CFGS[key], params, batch, user,
                                 cand, N_USER, STEPS)))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_ranks, W.jobs, 4, todo, backend="gloo",
                      store_dir=str(tmp_path_factory.mktemp("fm4")),
                      timeout_s=SPAWN_TIMEOUT_S)
    yield fut, list(CASES)
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def refs(pending):
    """{config key: (one process, reference)}."""
    return {key: (one_process(key), reference(key)) for key in CFGS}


@pytest.fixture(scope="module")
def runs(pending, refs):
    """{case name: [each rank's result]}."""
    fut, names = pending
    res = fut.result()
    return {name: [r[i] for r in res] for i, name in enumerate(names)}


def _close(got, want):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **TOL)


@pytest.mark.parametrize("part", ["losses", "params", "grads", "grad_loss",
                                  "serve", "retrieval"])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_cells_match_one_process(name, part, runs, refs):
    _, key = CASES[name]
    for r in runs[name]:
        _close(r[part], refs[key][0][part])


@pytest.mark.parametrize("part", ["grads", "grad_loss", "serve",
                                  "retrieval"])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_cells_match_reference(name, part, runs, refs):
    _, key = CASES[name]
    _close(runs[name][0][part], refs[key][1][part])


@pytest.mark.parametrize("name", list(CASES))
def test_layout_and_exact_lookup(name, runs):
    """The tables are row-sharded exactly where their rows divide over
    the ranks, and there the lookup equals ``take`` bit for bit."""
    _, key = CASES[name]
    for r in runs[name]:
        assert r["rows"] == (key == "rows")
        if r["rows"]:
            assert r["lookup_equal"]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    store = tmp_path_factory.mktemp("fm1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("key", list(CFGS))
def test_cells_on_one_rank_are_the_unsharded_steps(key, one_rank):
    """On (1, 1) (rows split over one rank) the three cells' ``fn`` are
    ``torch.equal`` to the unsharded train, serve and retrieval steps."""
    cfg = CFGS[key]
    params, batch, user, cand = inputs(key)
    shape_cells, arch = W.cells(cfg, BATCH, N_CAND, N_USER)
    progs = {k: specs.build_fm_cell(arch, c, one_rank)
             for k, c in shape_cells.items()}
    assert progs["train"].in_specs[0]["v"][0] is not None
    b = tree_from_numpy(batch, "cpu")
    outs = []
    for step in (tsteps.make_fm_train_step(cfg, AdamW(lr=1e-3)),
                 progs["train"].fn):
        p = tree_from_numpy(params, "cpu")
        s, leaves = AdamW(lr=1e-3).init(p), []
        for _ in range(STEPS):
            p, s, aux = step(p, s, b)
            leaves.append(aux["loss"])
        outs.append(leaves + tree_leaves(p) + tree_leaves(s))
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    p = tree_from_numpy(params, "cpu")
    assert torch.equal(progs["serve"].fn(p, b),
                       tsteps.make_fm_serve_step(cfg)(p, b))
    u, c = torch.from_numpy(user), torch.from_numpy(cand)
    assert torch.equal(progs["retrieval"].fn(p, u, c),
                       tsteps.make_fm_retrieval_step(cfg, N_USER)(p, u, c))
