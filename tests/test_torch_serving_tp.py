"""Sharded serving of the LM: ``transformer.prefill`` and ``decode_step``
under the serving plan ("tp_fsdp", ``distributed.tp.LMPlan`` with the
cell's global batch) on gloo process groups on the CPU.

One spawn of 4 ranks (``repro_torch.launch.local.run_ranks``; the rank
programs are ``tests/_torch_serving_workers.py``) runs every case: the
SMOKE configs of qwen3-0.6b, granite-8b, mixtral-8x7b with tensor
parallelism inside its 3 experts (capacity factor 0.5: tokens drop, the
capacity ranked over the global batch) and qwen3-moe with expert
parallelism (capacity factor 4 = E / k: no drop, so the per-rank
capacity of the expert-parallel layer and the global one agree), each
on (2, 2) (whole heads), (1, 4) (2 kv heads over 4 model ranks: the
projections gathered) and (4, 1) (one sequence a data rank); and a
batch of 1, which the data axes do not divide (whole on every rank, the
reference's ``fit_specs``), on (4, 1) and, with the TP experts, on
(2, 2). Each prefills 20 tokens into a 24-slot cache (mixtral's window
of 16 rolls the ring) and decodes 2 tokens at f32 compute with an f32
cache; the logits and caches, gathered, are held within ``rtol=1e-5,
atol=1e-6`` of the unsharded passes and within ``tests/test_torch_lm``'s
``_close`` tolerance (``rtol=1e-4, atol=1e-5``) of the reference's
``prefill`` / ``decode_step``. At world size 1 (in this process) the
cell programs of ``launch.specs.build_lm_cell`` at bf16 are
``torch.equal`` to the unsharded prefill and decode steps.
"""
import concurrent.futures
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import tree_from_numpy
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.tp import LMPlan
from repro_torch.launch import specs
from repro_torch.launch.local import run_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tT
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves, tree_map

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_serving_workers as W  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
REF_TOL = dict(rtol=1e-4, atol=1e-5)
SPAWN_TIMEOUT_S = 180.0
BATCH, PROMPT, N_DEC, MAX_LEN = 4, 20, 2, 24
# key: (arch, MoE dict the case passes, config changes)
ARCHS = {
    "qwen3": ("qwen3-0.6b", None, ()),
    "granite": ("granite-8b", None, ()),
    "mixtral_tp": ("mixtral-8x7b", "tp",
                   (("capacity_factor", 0.5), ("n_experts", 3))),
    "qwen3moe_ep": ("qwen3-moe-235b-a22b", "ep",
                    (("capacity_factor", 4.0),)),
}
ATTN = {(2, 2): "heads", (1, 4): "gathered", (4, 1): "heads"}
CASES = {f"{key}_{m[0]}x{m[1]}": (m, key, BATCH)
         for key in ARCHS for m in ATTN}
CASES["qwen3_batch1_4x1"] = ((4, 1), "qwen3", 1)
CASES["mixtral_tp_batch1_2x2"] = ((2, 2), "mixtral_tp", 1)


def _cfgs(key):
    from repro.configs import get_arch as jax_get_arch
    arch, _, kw = ARCHS[key]
    return (dataclasses.replace(jax_get_arch(arch).smoke, **dict(kw)),
            dataclasses.replace(get_arch(arch).smoke, **dict(kw)))


@functools.lru_cache(maxsize=None)
def inputs(key, batch):
    """(reference config, port config, numpy params from the port's
    seeded init, numpy tokens [batch, PROMPT + N_DEC])."""
    jcfg, tcfg = _cfgs(key)
    params = tree_map(lambda v: v.numpy(), tT.init_params(
        tcfg, torch.Generator().manual_seed(5), "cpu"))
    tok = np.random.default_rng(batch).integers(
        0, tcfg.vocab, (batch, PROMPT + N_DEC)).astype(np.int32)
    return jcfg, tcfg, params, tok


def _arrays(logits, first, dec, last) -> dict:
    out = {"prefill": logits, "cache": first, "decode": dec, "last": last}
    return tree_map(lambda x: np.asarray(x), out)


def unsharded(key, batch) -> dict:
    _, tcfg, params, tok = inputs(key, batch)
    out = W.serve(tcfg, tree_from_numpy(params, "cpu"),
                  torch.from_numpy(tok), N_DEC, MAX_LEN)
    return _arrays(*tree_map(lambda x: x.numpy(), out))


def reference(key, batch) -> dict:
    """The reference's f32 prefill (f32 cache), last-position logits and
    ``N_DEC`` decode steps."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jT

    jcfg, _, params, tok = inputs(key, batch)
    jp = jax.tree.map(jnp.asarray, params)
    h, cache = jT.prefill(jp, jnp.asarray(tok[:, :PROMPT]), jcfg,
                          max_len=MAX_LEN, q_chunk=8, k_chunk=8,
                          compute_dtype=None, cache_dtype=jnp.float32)
    logits = jT.logits_fn(jp, h[:, -1:], jcfg)
    decode = jax.jit(lambda p, c, t: jT.decode_step(p, c, t, jcfg,
                                                    compute_dtype=None))
    first, dec = cache, []
    for i in range(N_DEC):
        lg, cache = decode(jp, cache, jnp.asarray(
            tok[:, PROMPT + i:PROMPT + i + 1]))
        dec.append(lg)
    return _arrays(logits, first, dec, cache)


@pytest.fixture(scope="module")
def pending(tmp_path_factory):
    """The 4-rank spawn of every case, started on a thread (the
    references are computed meanwhile): (future, [case names])."""
    todo = []
    for name, (shape, key, batch) in CASES.items():
        _, tcfg, params, tok = inputs(key, batch)
        todo.append(("serve_worker", (shape, tcfg, ARCHS[key][1], params,
                                      tok, N_DEC, MAX_LEN)))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_ranks, W.jobs, 4, todo, backend="gloo",
                      store_dir=str(tmp_path_factory.mktemp("serve4")),
                      timeout_s=SPAWN_TIMEOUT_S)
    yield fut, list(CASES)
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def refs(pending):
    """{(arch key, batch): (unsharded, reference)}."""
    return {(key, batch): (unsharded(key, batch), reference(key, batch))
            for _, key, batch in CASES.values()}


@pytest.fixture(scope="module")
def runs(pending, refs):
    """{case name: [each rank's result]}."""
    fut, names = pending
    res = fut.result()
    return {name: [r[i] for r in res] for i, name in enumerate(names)}


def _held(got, want, tol):
    for part in ("prefill", "cache", "decode", "last"):
        a, b = tree_leaves(got[part]), tree_leaves(want[part])
        assert len(a) == len(b), part
        for x, y in zip(a, b):
            if np.issubdtype(np.asarray(y).dtype, np.integer):
                np.testing.assert_array_equal(x, y, err_msg=part)
            else:
                np.testing.assert_allclose(x, y, err_msg=part, **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_unsharded(name, runs, refs):
    _, key, batch = CASES[name]
    _held(runs[name][0], refs[key, batch][0], TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_reference(name, runs, refs):
    _, key, batch = CASES[name]
    _held(runs[name][0], refs[key, batch][1], REF_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_runs_the_planned_modes_and_ranks_agree(name,
                                                                runs):
    """Each case runs the attention mode of its mesh, its MoE mode, and
    its batch axes (none where the batch does not divide); every layer
    gathers its weights (all-gathers) and the row-parallel outputs are
    all-reduced; every rank holds the same gathered results."""
    shape, key, batch = CASES[name]
    res = runs[name]
    moe = ARCHS[key][1]
    assert tuple(res[0]["plan"]) == (
        ATTN[shape], "split" if moe != "ep" else "replicated", moe,
        ("data",) if batch % shape[0] == 0 else ())
    assert res[0]["counts"]["all_gather"] > 0
    assert res[0]["counts"]["all_reduce"] > 0
    for r in res[1:]:
        for part in ("prefill", "cache", "decode", "last"):
            for a, b in zip(tree_leaves(r[part]), tree_leaves(res[0][part])):
                np.testing.assert_array_equal(a, b)


def test_mixtral_case_drops_tokens():
    """At the TP cases' capacity factor the MoE layer drops assignments
    in the prefill: its output differs from the layer's at E / k."""
    _, tcfg, params, _ = inputs("mixtral_tp", BATCH)
    lp = {k: torch.from_numpy(v[0].copy())
          for k, v in params["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH * PROMPT, tcfg.d_model)).astype(np.float32))
    a, b = (tT.moe_ffn(x, lp, dataclasses.replace(tcfg, capacity_factor=c))
            for c in (tcfg.capacity_factor, tcfg.n_experts / tcfg.top_k))
    assert not torch.allclose(a, b)


# ------------------------------------------------------- world size 1 -----
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    store = tmp_path_factory.mktemp("serve1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("key,force_tp", [(k, False) for k in ARCHS]
                         + [("mixtral_tp", True)])
def test_one_rank_cells_are_bitwise_the_unsharded_passes(key, force_tp,
                                                         one_rank):
    """The prefill and decode cells of ``build_lm_cell`` (bf16 parameter
    structs, the cell's MoE dict; with ``force_tp`` the tensor-parallel
    dict) on the (1, 1) mesh, on bf16 parameters: the prefill's logits
    and cache and two decodes' logits and caches ``torch.equal`` to
    ``make_lm_prefill_step`` / ``make_lm_decode_step`` without a plan."""
    _, tcfg, params, tok = inputs(key, BATCH)
    arch = dataclasses.replace(get_arch(ARCHS[key][0]), config=tcfg)
    pre = specs.build_lm_cell(arch, ShapeCell("p", "prefill", seq_len=MAX_LEN,
                                              global_batch=BATCH), one_rank)
    dec = specs.build_lm_cell(arch, ShapeCell("d", "decode", seq_len=MAX_LEN,
                                              global_batch=BATCH), one_rank)
    assert (pre.step_name, dec.step_name, dec.donate) == (
        "prefill_step", "serve_step", (1,))
    fns = (pre.fn, dec.fn)
    k_chunk = tT.cache_len(tcfg, MAX_LEN)          # the decode cell's
    if force_tp:
        ms = tshd.tp_expert_shardings(one_rank)
        plan = LMPlan(dataclasses.replace(tcfg, parallelism="tp_fsdp"),
                      one_rank, ms, batch=BATCH)
        assert plan.moe == "tp"
        fns = (tsteps.make_lm_prefill_step(tcfg, max_len=MAX_LEN, plan=plan),
               tsteps.make_lm_decode_step(tcfg, k_chunk=k_chunk, plan=plan))
    full = tree_map(lambda v: v.to(torch.bfloat16),
                    tree_from_numpy(params, "cpu"))
    # the cell's struct dtypes are the parameters'
    assert [x.dtype for x in tree_leaves(pre.args[0])] == [
        x.dtype for x in tree_leaves(full)]
    local = tshd.shard_tree(full, pre.in_specs[0], one_rank)
    plain = (tsteps.make_lm_prefill_step(tcfg, max_len=MAX_LEN),
             tsteps.make_lm_decode_step(tcfg, k_chunk=k_chunk))
    t = torch.from_numpy(tok)
    outs = []
    for (prefill, decode), p in ((plain, full), (fns, local)):
        lg, cache = prefill(p, t[:, :PROMPT])
        got = [lg, {k: v.clone() for k, v in cache.items()}]
        for i in range(N_DEC):
            lg, cache = decode(p, cache, t[:, PROMPT + i:PROMPT + i + 1])
            got += [lg, {k: v.clone() for k, v in cache.items()}]
        outs.append(tree_leaves(got))
    assert len(outs[0]) == len(outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
