"""Tensor-parallel, sequence-parallel and FSDP execution of the LM, and
the sharded energy steps, on gloo process groups on the CPU.

Each spawn (``repro_torch.launch.local.run_ranks``) starts its ranks in
processes of their own, joined through a file store under a temporary
directory; the rank programs are in ``tests/_torch_tp_workers.py``. One
spawn per world size (2, 3, 4) runs every case of that size; world size
1 runs in this process.

The sharded loss and its gradients (gathered with ``gather_tree``) are
held against the port's unsharded ones and against the reference's
``jax.value_and_grad`` of its f32 LM loss on the full parameters, within
``rtol=1e-5, atol=1e-6``: qwen3-0.6b-smoke under "tp_fsdp" on (2, 2)
(whole heads), smollm-smoke on (1, 2) (3 heads: columns split
mid-head, gathered before attention), granite-smoke under "fsdp" on
(2, 2), qwen3-0.6b-smoke with a tied head on (2, 2), mixtral-smoke
with tensor parallelism inside the experts on (1, 3) (4 experts), on
(2, 2) (3 experts, capacity ranked over both data ranks) and on (4, 1)
(a global capacity above a rank's token count, each expert's slots a
window of that count), at capacity factors that drop tokens,
qwen3-moe-smoke's expert parallelism with ZeRO-3 expert stacks on
(2, 2); a clipped AdamW step (its loss, norm and first moment); the
DimeNet and NequIP energy steps on 4 ranks. Each case runs under its config's ``parallelism``, given
the reference's ``act_constraint`` for it. At world size 1 every
strategy is ``torch.equal`` to the unsharded step.
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
from repro_torch.convert import tree_from_numpy
from repro_torch.data.graphs import random_molecules
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed import tp
from repro_torch.launch.local import run_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import dimenet as tdimenet
from repro_torch.models import nequip as tnequip
from repro_torch.models import transformer as tT
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves, tree_map

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_tp_workers as W  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT_S = 180.0
BATCH, SEQ = 4, 24            # SEQ divides over 2 and 3 model ranks
# name: (mesh, arch, moe dict, config changes); the strategy is the
# config's parallelism ("tp_fsdp" by default; granite-8b's CONFIG has
# "fsdp", which its SMOKE config is given here)
LM_CASES = {
    "qwen3_tp_fsdp_2x2": ((2, 2), "qwen3-0.6b", None, {}),
    "smollm_mid_head_1x2": ((1, 2), "smollm-360m", None, {}),
    "granite_fsdp_2x2": ((2, 2), "granite-8b", None,
                         dict(parallelism="fsdp")),
    # the head is the embedding's transpose: each rank's sequence block
    # against the whole vocabulary
    "qwen3_tied_2x2": ((2, 2), "qwen3-0.6b", None,
                       dict(tie_embeddings=True)),
    # d_ff 96 splits over 3 ranks; at capacity factor 0.5 tokens drop
    "mixtral_tp_experts_1x3": ((1, 3), "mixtral-8x7b", "tp",
                               dict(d_ff=96, capacity_factor=0.5)),
    # 3 experts do not divide over 2 model ranks: TP inside the experts,
    # capacity ranked over both data ranks' tokens
    "mixtral_tp_experts_2x2": ((2, 2), "mixtral-8x7b", "tp",
                               dict(n_experts=3, d_ff=96,
                                    capacity_factor=0.5)),
    # 4 data ranks of 24 tokens: the global capacity (36) exceeds a
    # rank's tokens, so each expert's window is the 24 tokens; drops
    "mixtral_tp_experts_4x1": ((4, 1), "mixtral-8x7b", "tp",
                               dict(capacity_factor=0.75)),
    # E / k = 4: no drop, so the per-rank capacity of the reference's
    # expert-parallel layer and the global one agree
    "qwen3moe_ep_fsdp_2x2": ((2, 2), "qwen3-moe-235b-a22b", None,
                             dict(capacity_factor=4.0)),
}
PLANS = {   # (attention, ffn, moe, head) each case must run
    "qwen3_tp_fsdp_2x2": ("heads", "split", None, "vocab"),
    "smollm_mid_head_1x2": ("gathered", "split", None, "vocab"),
    "granite_fsdp_2x2": ("replicated", "replicated", None, "seq"),
    "qwen3_tied_2x2": ("heads", "split", None, "seq"),
    "mixtral_tp_experts_1x3": ("replicated", "split", "tp", "seq"),
    "mixtral_tp_experts_2x2": ("heads", "split", "tp", "vocab"),
    "mixtral_tp_experts_4x1": ("heads", "split", "tp", "vocab"),
    "qwen3moe_ep_fsdp_2x2": ("heads", "replicated", "ep", "vocab"),
}
# the gradient's global norm is above clip_norm, so the step clips
CLIP_OPT = dict(lr=1e-3, weight_decay=0.01, clip_norm=0.05)
ENERGY_STEPS, ENERGY_LR = 3, 1e-3
# 8 molecules of 8 atoms: 64 atoms, 200 edges and 656 triplets, each
# dividing over 4 ranks, every edge and triplet index within one shard
# of its position (the halo contract)
MOLS = dict(n_mols=8, atoms_per_mol=8, cutoff=3.0, seed=1)
FIELDS = {"dimenet": tdimenet.MoleculeBatch._fields[:-1],
          "nequip": tnequip.AtomGraph._fields[:-1]}
RELAYOUT_INPUTS = (
    np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8),
    np.random.default_rng(0).standard_normal((4, 6, 8)).astype(np.float32))
def _ep_fsdp_inputs():
    """qwen3-moe-smoke with 4 experts (2 a model rank): one layer's
    numpy weights, 16 tokens and a cotangent, seeded."""
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b").smoke,
                              n_experts=4, capacity_factor=2.0)
    lp = tT.init_layer_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((16, cfg.d_model)).astype(np.float32)
    return cfg, x, {k: v.numpy() for k, v in lp.items()
                    if k in ("router", "w_gate", "w_up", "w_down")}, ct


EP_FSDP_INPUTS = _ep_fsdp_inputs()
RELAYOUTS = [((), ("data", None, "model")),
             (("data", "model", None), ("data", None, None)),
             (("data", "model", None), ("data", None, "model")),
             ((("data", "model"), None, None), ()),
             ((None, "model", None), ("model", None, None))]


def _cfgs(arch, **kw):
    from repro.configs import get_arch as jax_get_arch
    return (dataclasses.replace(jax_get_arch(arch).smoke, **kw),
            dataclasses.replace(get_arch(arch).smoke, **kw))


@functools.lru_cache(maxsize=None)
def lm_inputs(arch, kw=(), seed=3):
    """(reference config, port config, numpy params from the port's
    seeded init, numpy batch); ``kw`` the config changes as items."""
    jcfg, tcfg = _cfgs(arch, **dict(kw))
    params = tree_map(lambda v: v.numpy(), tT.init_params(
        tcfg, torch.Generator().manual_seed(seed), "cpu"))
    tok = np.random.default_rng(seed).integers(0, tcfg.vocab,
                                               (BATCH, SEQ + 1))
    return jcfg, tcfg, params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _case_inputs(name):
    _, arch, _, kw = LM_CASES[name]
    return lm_inputs(arch, tuple(sorted(kw.items())))


def unsharded(tcfg, params, batch):
    """The port's unsharded loss and gradient leaves (numpy)."""
    fn = tsteps.make_lm_value_and_grad(tcfg, **W.LM_KW)
    loss, grads = fn(tree_from_numpy(params, "cpu"),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), [g.numpy() for g in tree_leaves(grads)]


def reference(jcfg, params, batch):
    """``jax.value_and_grad`` of the reference's f32 LM loss."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jT
    from repro.train.steps import chunked_cross_entropy as jxent

    def loss(p):
        h = jT.forward(p, jnp.asarray(batch["tokens"]), jcfg, remat=True,
                       compute_dtype=None, q_chunk=8, k_chunk=8)
        head = p["embed"].T if jcfg.tie_embeddings else p["lm_head"]
        return jxent(h, head, jnp.asarray(batch["labels"]), chunk=8)
    val, grads = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, params))
    return float(val), [np.asarray(g) for g in
                        jax.tree_util.tree_leaves(grads)]


@functools.lru_cache(maxsize=None)
def molecule_inputs(arch):
    from repro.configs import get_arch as jax_get_arch
    jcfg, tcfg = jax_get_arch(arch).smoke, get_arch(arch).smoke
    init = tdimenet.dimenet_init if arch == "dimenet" else \
        tnequip.nequip_init
    params = tree_map(lambda v: v.numpy(), init(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    mols = random_molecules(**MOLS)
    batch = {k: mols[k] for k in FIELDS[arch]}
    batch["energy"] = np.random.default_rng(7).standard_normal(
        MOLS["n_mols"]).astype(np.float32)
    return jcfg, tcfg, params, batch


def _spawn(todo, world, store_dir):
    return run_ranks(W.jobs, world, todo, backend="gloo",
                     store_dir=str(store_dir), timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def pending(tmp_path_factory):
    """The spawns, one per world size, started together on threads (the
    references are computed meanwhile): ({world: future}, {world: [case
    names]})."""
    todo, names = {}, {}
    for name, (shape, _, moe, _) in LM_CASES.items():
        _, tcfg, params, batch = _case_inputs(name)
        world = int(np.prod(shape))
        todo.setdefault(world, []).append(
            ("lm_worker", (shape, tcfg, moe, params, batch)))
        names.setdefault(world, []).append(name)
    _, tcfg, params, batch = lm_inputs("qwen3-0.6b")
    todo[4].append(("clip_worker", ((2, 2), tcfg, params, batch,
                                    topt.AdamW(**CLIP_OPT))))
    names[4].append("clip")
    for arch in ("dimenet", "nequip"):
        _, tcfg, params, batch = molecule_inputs(arch)
        todo[4].append(("energy_worker", (tcfg, params, batch,
                                          ENERGY_STEPS, ENERGY_LR)))
        names[4].append(arch)
    todo[4].append(("relayout_worker", ((2, 2),) + RELAYOUT_INPUTS
                    + (RELAYOUTS,)))
    names[4].append("relayout")
    _, tcfg, params, batch = _case_inputs("smollm_mid_head_1x2")
    todo[2].append(("forward_worker", ((1, 2), tcfg, params,
                                       batch["tokens"])))
    names[2].append("forward")
    todo[4].append(("ep_fsdp_worker", EP_FSDP_INPUTS))
    names[4].append("ep_fsdp")
    _, tcfg, params, batch = _case_inputs("mixtral_tp_experts_1x3")
    todo[2].append(("whole_tensor_tp_worker", ((2, 1), tcfg, params,
                                               batch["tokens"])))
    names[2].append("whole_tensor_tp")
    pool = concurrent.futures.ThreadPoolExecutor(len(todo))
    futs = {world: pool.submit(_spawn, jobs, world,
                               tmp_path_factory.mktemp(f"tp{world}"))
            for world, jobs in todo.items()}
    yield futs, names
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def lm_refs(pending):
    """{case: (unsharded, reference)}, each (loss, gradient leaves)."""
    out = {}
    for name in LM_CASES:
        jcfg, tcfg, params, batch = _case_inputs(name)
        out[name] = (unsharded(tcfg, params, batch),
                     reference(jcfg, params, batch))
    return out


@pytest.fixture(scope="module")
def energy_refs(pending):
    """{arch: (the unsharded step's losses, first gradients and final
    parameters, the reference's first loss and gradients)}."""
    import jax
    import jax.numpy as jnp
    from repro.train import steps as jsteps
    out = {}
    for arch in ("dimenet", "nequip"):
        jcfg, tcfg, params, batch = molecule_inputs(arch)
        seen = []
        opt = topt.AdamW(lr=ENERGY_LR)
        step = tsteps.make_gnn_train_step(
            tcfg, opt, compress=lambda g: seen.append(g) or g)
        p = tree_from_numpy(params, "cpu")
        s = opt.init(p)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        losses = []
        for _ in range(ENERGY_STEPS):
            p, s, aux = step(p, s, tb)
            losses.append(float(aux["loss"]))
        jloss = (jsteps.energy_loss_dimenet if arch == "dimenet"
                 else jsteps.energy_loss_nequip)
        jl, jg = jax.jit(jax.value_and_grad(jloss), static_argnums=2)(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        out[arch] = dict(
            losses=losses, grads=[g.numpy() for g in tree_leaves(seen[0])],
            params=[v.numpy() for v in tree_leaves(p)],
            ref=(float(jl), [np.asarray(g) for g in
                             jax.tree_util.tree_leaves(jg)]))
    return out


@pytest.fixture(scope="module")
def runs(pending, lm_refs, energy_refs):
    """{case name: [each rank's result]}."""
    futs, names = pending
    out = {}
    for world, fut in futs.items():
        for i, name in enumerate(names[world]):
            out[name] = [r[i] for r in fut.result()]
    return out


def _close(got, want):
    loss, grads = got
    np.testing.assert_allclose(loss, want[0], **TOL)
    assert len(grads) == len(want[1])
    for a, b in zip(grads, want[1]):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("name", list(LM_CASES))
def test_sharded_lm_matches_unsharded(name, runs, lm_refs):
    r = runs[name][0]
    _close((r["loss"], r["grads"]), lm_refs[name][0])


@pytest.mark.parametrize("name", list(LM_CASES))
def test_sharded_lm_matches_reference(name, runs, lm_refs):
    r = runs[name][0]
    _close((r["loss"], r["grads"]), lm_refs[name][1])


@pytest.mark.parametrize("name", list(LM_CASES))
def test_sharded_lm_runs_the_planned_modes_and_ranks_agree(name, runs):
    """Each case covers the modes it is named for, issues the collectives
    its plan predicts (``LMPlan.predicted_counts``), and every rank holds
    the same loss and the same gathered gradients."""
    res = runs[name]
    assert tuple(res[0]["plan"]) == PLANS[name]
    for r in res:
        assert r["counts"] == r["predicted"]
    for r in res[1:]:
        assert r["loss"] == res[0]["loss"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(r["grads"], res[0]["grads"]))


def test_mixtral_case_drops_tokens():
    """At the cases' capacity factor the MoE layer drops assignments: its
    output differs from the layer's at E / k (no drop)."""
    _, tcfg, params, _ = _case_inputs("mixtral_tp_experts_1x3")
    lp = {k: torch.from_numpy(v[0].copy())
          for k, v in params["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH * SEQ, tcfg.d_model)).astype(np.float32))
    cfgs = [dataclasses.replace(tcfg, capacity_factor=c)
            for c in (tcfg.capacity_factor, tcfg.n_experts / tcfg.top_k)]
    a, b = (tT.moe_ffn(x, lp, c) for c in cfgs)
    assert not torch.allclose(a, b)


def test_clipped_step_matches_unsharded(runs):
    """A clipped AdamW step whose global norm exceeds ``clip_norm``: the
    sharded loss, norm (each distinct block counted once) and first
    moment after the step (the clipped gradient times ``1 - b1``; the
    parameters' update is about ``lr * sign(g)`` and so flips on
    reduction-order noise) equal the unsharded step's and the
    reference's (``repro.train.optimizer.AdamW`` on
    ``jax.value_and_grad``'s gradients)."""
    import jax
    import jax.numpy as jnp
    from repro.train import optimizer as jopt

    jcfg, tcfg, params, batch = lm_inputs("qwen3-0.6b")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    norms = []
    opt = topt.AdamW(**CLIP_OPT)
    step = tsteps.make_lm_train_step(
        tcfg, opt, compress=lambda g: norms.append(topt.global_norm(g))
        or g, **W.LM_KW)
    p = tree_from_numpy(params, "cpu")
    _, state, aux = step(p, opt.init(p), tb)
    port = (float(aux["loss"]), float(norms[0]),
            [v.numpy() for v in tree_leaves(state.mu)])
    jloss, jgrads = reference(jcfg, params, batch)
    jp = jax.tree.map(jnp.asarray, params)
    jg = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp),
                                      [jnp.asarray(g) for g in jgrads])
    jopt_ = jopt.AdamW(**CLIP_OPT)
    _, jstate = jopt_.update(jg, jopt_.init(jp), jp)
    ref = (jloss, float(jopt.global_norm(jg)),
           [np.asarray(v) for v in jax.tree_util.tree_leaves(jstate.mu)])
    assert port[1] > CLIP_OPT["clip_norm"]
    for r in runs["clip"]:
        for want in (port, ref):
            np.testing.assert_allclose(r["loss"], want[0], **TOL)
            np.testing.assert_allclose(r["norm"], want[1], **TOL)
            assert len(r["mu"]) == len(want[2])
            for a, b in zip(r["mu"], want[2]):
                np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("arch", ["dimenet", "nequip"])
def test_sharded_energy_step_matches_unsharded_and_reference(
        arch, runs, energy_refs):
    """4 ranks over the halo ops: losses, the first step's gradients and
    the parameters after 3 AdamW steps against the unsharded step's, and
    the first loss and gradients against ``jax.value_and_grad``."""
    want = energy_refs[arch]
    for r in runs[arch]:
        np.testing.assert_allclose(r["losses"], want["losses"], **TOL)
        _close((r["losses"][0], r["grads"]),
               (want["losses"][0], want["grads"]))
        _close((r["losses"][0], r["grads"]), want["ref"])
        for a, b in zip(r["params"], want["params"]):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("case", range(len(RELAYOUTS)))
def test_with_sharding_constraint_moves_blocks_on_four_ranks(case, runs):
    """Each rank's block under ``dst`` from its block under ``src``
    (slice, all-gather, all-to-all), and the backward the reverse
    change: the cotangent's ``src`` block."""
    x, ct = RELAYOUT_INPUTS
    mesh = type("M", (), {"shape": {"data": 2, "model": 2},
                          "axis_names": ("data", "model")})()
    src, dst = (tshd.P(*s) for s in RELAYOUTS[case])
    for rank, res in enumerate(runs["relayout"]):
        got = res[case]
        np.testing.assert_array_equal(
            got["y"], x[tshd.local_slice(dst, x.shape, mesh, rank)])
        np.testing.assert_array_equal(
            got["grad"], ct[tshd.local_slice(src, ct.shape, mesh, rank)])


def test_moe_ffn_ep_gathers_zero3_expert_stacks(runs):
    """``moe_ffn_ep`` given expert stacks whose second dimension is split
    over `data` gathers them on entry: the output of the whole stacks',
    and the gradients reduce-scattered, each rank's block of the whole
    stacks' gradients summed over `data`."""
    for r in runs["ep_fsdp"]:
        np.testing.assert_allclose(r["fsdp"]["y"], r["whole"]["y"], **TOL)
        for k, g in r["whole"]["grads"].items():
            np.testing.assert_allclose(r["fsdp"]["grads"][k], g, **TOL)
            assert np.abs(g).max() > 0, k


def test_constraints_over_several_ranks_run(runs):
    """``forward`` given only the reference's ``act_constraint``
    ``P(dp, model, None)`` over 2 model ranks (smollm-smoke, columns
    split mid-head) runs sharded: its blocks, gathered, are the
    unsharded forward's normed hidden."""
    _, tcfg, params, batch = _case_inputs("smollm_mid_head_1x2")
    want = tT.forward(tree_from_numpy(params, "cpu"),
                      torch.from_numpy(batch["tokens"]), tcfg,
                      compute_dtype=None, q_chunk=8, k_chunk=8)
    for got in runs["forward"]:
        np.testing.assert_allclose(got, want.detach().numpy(), **TOL)


@pytest.mark.parametrize("call", ["forward", "prefill", "decode_step"])
def test_whole_tensor_passes_refuse_a_multi_rank_tp_dict(call, runs):
    """On a (2, 1) mesh, the passes over whole tensors given the
    tensor-parallel MoE dict refuse it (it needs this data rank's block
    of the tokens) instead of ranking capacity over tokens every rank
    holds whole: ``forward`` without an ``act_constraint`` raises
    ``NotImplementedError`` (only the sharded training forward holds a
    block), ``prefill`` and ``decode_step`` without a plan raise
    ``ValueError`` naming ``plan=`` (their sharded serving passes)."""
    want, hint = (("NotImplementedError", "act_constraint")
                  if call == "forward" else ("ValueError", "plan="))
    for r in runs["whole_tensor_tp"]:
        kind, msg = r[call]
        assert kind == want, (kind, msg)
        assert call in msg and hint in msg


# ------------------------------------------------------- world size 1 -----
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    store = tmp_path_factory.mktemp("tp1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", list(LM_CASES))
def test_one_rank_is_bitwise_the_unsharded_step(name, one_rank):
    """Two AdamW steps, bf16 compute: losses and parameters
    ``torch.equal`` to ``make_lm_train_step`` without a mesh."""
    _, _, moe, _ = LM_CASES[name]
    _, tcfg, params, batch = _case_inputs(name)
    full = tree_from_numpy(params, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    specs = tshd.lm_param_specs(tcfg, one_rank, full)
    ms = tshd.tp_expert_shardings(one_rank) if moe == "tp" else None
    out = []
    for mesh in (None, one_rank):
        opt = topt.AdamW(lr=1e-3)
        step = tsteps.make_lm_train_step(
            tcfg, opt, q_chunk=8, k_chunk=8, xent_chunk=8,
            act_constraint=None if mesh is None else W.residual(mesh, tcfg),
            moe_shardings=ms if mesh else None)
        p = full if mesh is None else tshd.shard_tree(full, specs, mesh)
        s = opt.init(p)
        losses = []
        for _ in range(2):
            p, s, aux = step(p, s, tb)
            losses.append(aux["loss"])
        out.append((losses, tree_leaves(p)))
    assert all(torch.equal(a, b) for a, b in zip(out[0][0], out[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_one_rank_issues_every_collective(one_rank):
    """Over one rank the plan's collectives still run: the count of a
    qwen3-0.6b-smoke "tp_fsdp" value-and-grad is the plan's."""
    _, tcfg, params, batch = lm_inputs("qwen3-0.6b")
    full = tree_from_numpy(params, "cpu")
    specs = tshd.lm_param_specs(tcfg, one_rank, full)
    fn = tsteps.make_lm_value_and_grad(
        tcfg, act_constraint=W.residual(one_rank, tcfg), **W.LM_KW)
    tp.reset_counts()
    fn(tshd.shard_tree(full, specs, one_rank),
       {k: torch.from_numpy(v) for k, v in batch.items()})
    assert dict(tp.COUNTS) == fn.plan.predicted_counts(SEQ, xent_chunk=8)
