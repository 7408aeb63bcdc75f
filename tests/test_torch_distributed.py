"""The sharded layer on gloo process groups on the CPU.

Each spawn (``repro_torch.launch.local.run_ranks``) starts its ranks in
processes of their own, joined through a file store under ``tmp_path``
(no fixed port: the suite runs under xdist), and returns numpy arrays;
the rank programs are in ``tests/_torch_dist_workers.py``. The spawns
are module fixtures, so one spawn serves several tests. World size 1
runs in this process.

The halo ops are held against numpy oracles (``np.take``, ``np.add.at``)
and, for indices outside the halo, against a numpy copy of the
reference's clamp; the expert-parallel MoE and its gradients against the
dense top-k mixture (the reference's own oracle, in JAX); the sharded
gatedgcn step against the unsharded port step and the reference's.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_arch as jax_get_arch
from repro.models import gnn as jgnn
from repro.models import transformer as jT
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_arch
from repro_torch.convert import tree_from_numpy
from repro_torch.core.formats import csr_from_scipy
from repro_torch.core.reorder import reorder
from repro_torch.data.graphs import sbm_graph
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.collectives import overlap_flags
from repro_torch.launch.local import run_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tT
from repro_torch.models.moe_ep import moe_ffn_ep
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_workers as W  # noqa: E402

HALO_TOL = 1e-5
EP_TOL = 5e-5
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT_S = 120.0
MESHES = {1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (4, 2)}


def _spawn(fn, world, *args, store_dir):
    return run_ranks(fn, world, *args, backend="gloo",
                     store_dir=str(store_dir), timeout_s=SPAWN_TIMEOUT_S)


# ------------------------------------------------------------------ halo ---
def halo_case(wide: int, seed: int = 0, n=64, m=48, d=5, shard=8):
    """The reference's halo test input (tests/test_distributed.py):
    indices within ``wide`` shards of 8 rows of their position."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    pos = np.arange(m) * n // m
    idx = np.clip(pos + rng.integers(-shard * wide, shard * wide, m), 0,
                  n - 1).astype(np.int64)
    vals = rng.standard_normal((m, d)).astype(np.float32)
    return x, idx, vals


def _halo_locs(idx, n, world):
    s, ms = n // world, idx.shape[0] // world
    return [np.clip(idx[r * ms:(r + 1) * ms] - (r * s - s), 0, 3 * s - 1)
            for r in range(world)]


def clamp_take(x, idx, world):
    """A numpy copy of the reference's halo take, clamp included."""
    n = x.shape[0]
    s = n // world
    blocks = [x[r * s:(r + 1) * s] for r in range(world)]
    out = []
    for r, loc in enumerate(_halo_locs(idx, n, world)):
        halo = np.concatenate([blocks[(r - 1) % world], blocks[r],
                               blocks[(r + 1) % world]])
        out.append(halo[loc])
    return np.concatenate(out)


def clamp_segment_sum(vals, idx, n, world):
    """A numpy copy of the reference's halo segment_sum, clamp included:
    center + from_left + from_right."""
    s, ms = n // world, idx.shape[0] // world
    accs = []
    for r, loc in enumerate(_halo_locs(idx, n, world)):
        acc = np.zeros((3 * s,) + vals.shape[1:], np.float64)
        np.add.at(acc, loc, vals[r * ms:(r + 1) * ms])
        accs.append(acc)
    return np.concatenate([
        accs[r][s:2 * s] + accs[(r - 1) % world][2 * s:]
        + accs[(r + 1) % world][:s] for r in range(world)])


HALO_CASES = [halo_case(1), halo_case(6, seed=1)]


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    """One spawn per world size (2, 4, 8), each rank running its jobs:
    the halo cases at every size, the sharded gatedgcn step at 4, the
    expert-parallel MoE and the elastic reshard at 8."""
    s = _gnn_setup()
    _, tcfg = _ep_cfgs()
    moe = _moe_inputs()
    todo = {2: [], 4: [("gnn_worker", ((2, 2), s["cfg"], s["params"],
                                       s["batch"], GNN_STEPS, GNN_LR))],
            8: [("moe_worker", (tcfg,) + moe["args"]),
                ("elastic_worker", (ELASTIC_FULL,))]}
    out = {}
    for world, extra in todo.items():
        out[world] = _spawn(
            W.jobs, world, [("halo_worker", (MESHES[world], HALO_CASES))]
            + extra, store_dir=tmp_path_factory.mktemp(f"w{world}"))
    return dict(out, gnn=s, moe=moe)


@pytest.fixture(scope="module")
def halo_runs(spawns):
    """{world: [per-case results concatenated over ranks]}."""
    return {world: [{k: np.concatenate([r["halo_worker"][c][k]
                                        for r in spawns[world]])
                     for k in spawns[world][0]["halo_worker"][c]}
                    for c in range(len(HALO_CASES))]
            for world in (2, 4, 8)}


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo process group of world size 1 in this process and its
    (1, 1) mesh."""
    store = tmp_path_factory.mktemp("pg1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def _halo_results(world, halo_runs, one_rank):
    if world == 1:
        return [W._halo(one_rank, ("data", "model"), *c) for c in HALO_CASES]
    return halo_runs[world]


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_halo_ops_match_numpy(world, halo_runs, one_rank):
    x, idx, vals = HALO_CASES[0]
    got = _halo_results(world, halo_runs, one_rank)[0]
    n = x.shape[0]
    seg = np.zeros_like(x)
    np.add.at(seg, idx, vals)
    take_grad = np.zeros_like(x)
    np.add.at(take_grad, idx, 2 * x[idx])
    assert np.abs(got["take"] - x[idx]).max() <= HALO_TOL
    assert np.abs(got["segment_sum"] - seg).max() <= HALO_TOL
    assert np.abs(got["take_grad"] - take_grad).max() <= HALO_TOL
    assert np.abs(got["segment_sum_grad"] - 2 * seg[idx]).max() <= HALO_TOL
    assert got["segment_sum"].shape == (n, x.shape[1])


@pytest.mark.parametrize("world", [4, 8])
def test_halo_clamps_indices_outside_the_halo(world, halo_runs):
    """Indices up to 48 rows away: the ops give the reference's clamped
    values (wrong for those indices), not the true gather."""
    x, idx, vals = HALO_CASES[1]
    n = x.shape[0]
    assert not _in_halo(idx, n, world)
    got = halo_runs[world][1]
    want_take = clamp_take(x, idx, world)
    want_seg = clamp_segment_sum(vals, idx, n, world)
    assert not np.allclose(want_take, x[idx])
    assert np.abs(got["take"] - want_take).max() <= HALO_TOL
    assert np.abs(got["segment_sum"] - want_seg).max() <= HALO_TOL
    # each op's gradient is the other's clamp: they are transposes
    assert np.abs(got["take_grad"] - clamp_segment_sum(
        2 * want_take, idx, n, world)).max() <= HALO_TOL
    assert np.abs(got["segment_sum_grad"] - clamp_take(
        2 * want_seg, idx, world)).max() <= HALO_TOL


# ------------------------------------------------------------------- MoE ---
def _ep_cfgs():
    kw = dict(n_experts=8, top_k=2, capacity_factor=8.0)
    return (dataclasses.replace(jax_get_arch("qwen3-moe-235b-a22b").smoke,
                                **kw),
            dataclasses.replace(get_arch("qwen3-moe-235b-a22b").smoke, **kw))


def _dense_mixture(x, lp, k):
    """The reference test's oracle: every expert on every token, the
    top-k mixed by their renormalized weights."""
    logits = x @ lp["router"]
    topv, topi = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    topv = topv / topv.sum(-1, keepdims=True)
    h = jax.nn.silu(jnp.einsum("td,edf->tef", x, lp["w_gate"])) \
        * jnp.einsum("td,edf->tef", x, lp["w_up"])
    y_all = jnp.einsum("tef,efd->ted", h, lp["w_down"])
    return jnp.einsum("tk,tkd->td", topv,
                      jnp.take_along_axis(y_all, topi[:, :, None], 1))


def _moe_inputs():
    """The reference test's layer and tokens, a seeded cotangent, and the
    dense mixture's output and vjp."""
    jcfg, _ = _ep_cfgs()
    lp = jT.init_layer_params(jcfg, jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (32, jcfg.d_model))
    ct = np.random.default_rng(2).standard_normal(
        (32, jcfg.d_model)).astype(np.float32)
    p = {k: lp[k] for k in ("router", "w_gate", "w_up", "w_down")}
    want, vjp = jax.vjp(lambda xx, pp: _dense_mixture(xx, pp, jcfg.top_k),
                        x, p)
    dx, dp = vjp(jnp.asarray(ct))
    layer = {k: np.asarray(v) for k, v in p.items()}
    return dict(args=(np.asarray(x), layer, ct), want=np.asarray(want),
                dx=np.asarray(dx), dp={k: np.asarray(v)
                                       for k, v in dp.items()})


@pytest.fixture(scope="module")
def moe_run(spawns):
    m = spawns["moe"]
    return ([r["moe_worker"] for r in spawns[8]], m["want"], m["dx"],
            m["dp"])


def test_moe_ep_output_matches_dense_mixture(moe_run):
    res, want, _, _ = moe_run
    for r in res:
        d, _ = r["coord"]
        assert np.abs(r["out"] - want[d * 16:(d + 1) * 16]).max() < EP_TOL


def test_moe_ep_expert_gradients_match_dense_mixture(moe_run):
    """Each rank's expert slice, its gradient summed over the data
    group, equals the oracle's: the output's all-reduce passes the
    replicated cotangent through (summing it again would give 4x)."""
    res, _, _, dp = moe_run
    for r in res:
        _, m = r["coord"]
        for k in ("w_gate", "w_up", "w_down"):
            got, want = r["grads"][k], dp[k][m * 2:(m + 1) * 2]
            assert np.abs(got - want).max() < EP_TOL, k
            assert np.abs(want).max() > 100 * EP_TOL, k


def test_moe_ep_token_and_router_gradients_sum_over_the_model_group(
        moe_run):
    res, _, dx, dp = moe_run
    for r in res:
        d, _ = r["coord"]
        assert np.abs(r["dx"] - dx[d * 16:(d + 1) * 16]).max() < EP_TOL
        assert np.abs(r["grads"]["router"] - dp["router"]).max() < EP_TOL


# --------------------------------------------------------------- elastic ---
ELASTIC_FULL = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
                "b": np.arange(16, dtype=np.float32)}


@pytest.fixture(scope="module")
def elastic_run(spawns):
    return [r["elastic_worker"] for r in spawns[8]]


def test_reshard_8_to_4_keeps_values(elastic_run):
    keep = (0, 1, 2, 3)
    mesh = type("M", (), {"shape": {"data": 2, "model": 2},
                          "axis_names": ("data", "model")})()
    specs = {"w": tshd.P("data", "model"), "b": tshd.P(("data", "model"))}
    for rank, res in enumerate(elastic_run):
        got = res[keep]
        if rank not in keep:
            assert got is None
            continue
        assert got["shape"] == (2, 2)
        for k, spec in specs.items():
            full = ELASTIC_FULL[k]
            want = full[tshd.local_slice(spec, full.shape, mesh, rank)]
            np.testing.assert_array_equal(got[k], want)


def test_reshard_replicates_dims_that_no_longer_divide(elastic_run):
    keep = (0, 1, 2)            # a 3 x 1 mesh: 8 and 16 rows over 3 ranks
    for rank, res in enumerate(elastic_run):
        got = res[keep]
        if rank not in keep:
            assert got is None
            continue
        assert got["shape"] == (3, 1)
        for k, full in ELASTIC_FULL.items():
            np.testing.assert_array_equal(got[k], full)


# ------------------------------------------------------- sharded gatedgcn --
GNN_STEPS, GNN_LR, D_FEAT = 3, 1e-3, 8


def gnn_batch(n=1024, n_edges=8192, seed=0):
    """The halo contract's graph: an SBM with every edge inside one of 16
    communities, RCM-reordered; edges in CSR row order (receiver = row,
    sender = column), features, labels and a mask seeded with numpy."""
    a = sbm_graph(n, n_edges, n_communities=16, intra_frac=1.0,
                  power_law=False, seed=seed)
    csr, _, _ = reorder(csr_from_scipy(a), "rcm")
    rows = np.repeat(np.arange(n), np.diff(csr.indptr))
    rng = np.random.default_rng(seed)
    e = rows.shape[0]
    return {"senders": csr.indices.astype(np.int64),
            "receivers": rows.astype(np.int64),
            "node_feat": rng.standard_normal((n, D_FEAT)).astype(np.float32),
            "edge_feat": rng.standard_normal((e, 4)).astype(np.float32),
            "labels": rng.integers(0, 4, n).astype(np.int64),
            "node_mask": (rng.random(n) < 0.5).astype(np.float32)}


def _in_halo(idx, n, world):
    """Every index of edge block r lies in node blocks r-1..r+1."""
    e = idx.shape[0]
    return bool(np.all(np.abs(idx // (n // world)
                              - np.arange(e) // (e // world)) <= 1))


def _gnn_setup():
    jcfg = jax_get_arch("gatedgcn").smoke
    params = jax.tree.map(np.asarray, jgnn.gatedgcn_init(
        jcfg, D_FEAT, 4, jax.random.PRNGKey(0)))
    batch = gnn_batch()
    # the unsharded port step and the reference's, same start
    tcfg = get_arch("gatedgcn").smoke
    opt = topt.AdamW(lr=GNN_LR)
    p = tree_from_numpy(params, "cpu")
    state = opt.init(p)
    step = tsteps.make_gnn_train_step(tcfg, opt, remat=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    port_losses = []
    for _ in range(GNN_STEPS):
        p, state, aux = step(p, state, tb)
        port_losses.append(float(aux["loss"]))
    jo = jopt.AdamW(lr=GNN_LR)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    jstep = jax.jit(jsteps.make_gnn_train_step(jcfg, jo, remat=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_losses = []
    for _ in range(GNN_STEPS):
        jp, js, aux = jstep(jp, js, jb)
        ref_losses.append(float(aux["loss"]))
    return dict(cfg=tcfg, params=params, batch=batch,
                port=(port_losses, [v.numpy() for v in tree_leaves(p)]),
                ref=(ref_losses, [np.asarray(v)
                                  for v in jax.tree_util.tree_leaves(jp)]))


@pytest.fixture(scope="module")
def gnn_setup(spawns):
    return spawns["gnn"]


@pytest.fixture(scope="module")
def gnn4_run(spawns):
    return [r["gnn_worker"] for r in spawns[4]]


def test_gnn_graph_keeps_the_halo_contract(gnn_setup):
    b = gnn_setup["batch"]
    for world in (4, 8):
        for key in ("senders", "receivers"):
            assert _in_halo(b[key], b["node_feat"].shape[0], world), key


def _close(got, want):
    losses, leaves = got
    np.testing.assert_allclose(losses, want[0], **STEP_TOL)
    assert len(leaves) == len(want[1])
    for a, b in zip(leaves, want[1]):
        np.testing.assert_allclose(a, b, **STEP_TOL)


def test_sharded_gnn_step_on_4_ranks_matches_unsharded(gnn_setup, gnn4_run):
    for r in gnn4_run:
        _close((r["losses"], r["params"]), gnn_setup["port"])
    # every rank took the same step
    for r in gnn4_run[1:]:
        assert r["losses"] == gnn4_run[0]["losses"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(r["params"], gnn4_run[0]["params"]))


def test_sharded_gnn_step_on_4_ranks_matches_reference(gnn_setup, gnn4_run):
    _close((gnn4_run[0]["losses"], gnn4_run[0]["params"]), gnn_setup["ref"])
    losses = gnn4_run[0]["losses"]
    assert losses[-1] < losses[0]


def test_sharded_gnn_step_on_one_rank_is_bitwise(gnn_setup, one_rank):
    s = gnn_setup
    out = W.gnn_worker(0, 1, (1, 1), s["cfg"], s["params"], s["batch"],
                       GNN_STEPS, GNN_LR)
    assert out["bitwise"]
    _close((out["losses"], out["params"]), s["port"])


@pytest.mark.parametrize("arch", ["dimenet", "nequip"])
def test_energy_models_have_a_sharded_step(arch, one_rank):
    """The halo step of the energy models (molecules summed over the
    group, each rank's share of the loss) over one rank: 3 AdamW steps
    bitwise-equal to the unsharded step (4 ranks:
    tests/test_torch_tp.py)."""
    from repro_torch.data.graphs import random_molecules
    from repro_torch.distributed.halo import make_halo_ops
    from repro_torch.models import dimenet, nequip

    cfg = get_arch(arch).smoke
    mols = random_molecules(4, 6, cutoff=3.0, seed=0)
    fields = (dimenet.MoleculeBatch if arch == "dimenet"
              else nequip.AtomGraph)._fields[:-1]
    batch = {k: torch.from_numpy(mols[k]) for k in fields}
    batch["energy"] = torch.from_numpy(np.random.default_rng(1)
                                       .standard_normal(4)
                                       .astype(np.float32))
    init = dimenet.dimenet_init if arch == "dimenet" else nequip.nequip_init
    params = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = []
    for gops in (None, make_halo_ops(one_rank, ("data", "model"))):
        opt = topt.AdamW(lr=1e-3)
        step = tsteps.make_gnn_train_step(cfg, opt, gops=gops)
        p, s = params, opt.init(params)
        losses = []
        for _ in range(3):
            p, s, aux = step(p, s, batch)
            losses.append(aux["loss"])
        out.append((losses, tree_leaves(p)))
    assert all(torch.equal(a, b) for a, b in zip(out[0][0], out[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ------------------------------------------------ the LM on a (1, 1) mesh --
def _lm(arch="qwen3-moe-235b-a22b", seed=0):
    cfg = get_arch(arch).smoke
    params = tT.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, 24)))
    return cfg, params, tokens


def _ep(mesh):
    return {"ep_mesh": mesh, "dp": ("data",), "mdl": "model"}


def test_moe_ffn_ep_on_one_rank_is_moe_ffn(one_rank):
    """Values and gradients bit for bit: the same arithmetic, with an
    all-reduce over one rank."""
    _, tcfg = _ep_cfgs()
    lp = tT.init_layer_params(tcfg, torch.Generator().manual_seed(0))
    x = torch.randn(32, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    outs, grads = [], []
    for ep in (False, True):
        p = {k: v.clone().requires_grad_(True) for k, v in lp.items()}
        xx = x.clone().requires_grad_(True)
        out = (moe_ffn_ep(xx, p, tcfg, one_rank, dp_axes=("data",),
                          mdl_axis="model") if ep
               else tT.moe_ffn(xx, p, tcfg))
        (out ** 2).sum().backward()
        outs.append(out)
        grads.append([xx.grad] + [p[k].grad for k in sorted(p)
                                  if p[k].grad is not None])
    assert torch.equal(outs[0], outs[1])
    assert len(grads[0]) == len(grads[1]) == 5
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_forward_prefill_decode_with_ep_mesh_equal_unsharded(one_rank):
    cfg, params, tokens = _lm()
    ep = _ep(one_rank)
    for dtype in (None, torch.bfloat16):
        a = tT.forward(params, tokens, cfg, compute_dtype=dtype, remat=False)
        b = tT.forward(params, tokens, cfg, compute_dtype=dtype,
                       remat=False, moe_shardings=ep)
        assert torch.equal(a, b)
    h1, c1 = tT.prefill(params, tokens, cfg, max_len=32)
    h2, c2 = tT.prefill(params, tokens, cfg, max_len=32, moe_shardings=ep)
    assert torch.equal(h1, h2)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)
    nxt = tokens[:, -1:]
    l1, _ = tT.decode_step(params, c1, nxt, cfg)
    l2, _ = tT.decode_step(params, c2, nxt, cfg, moe_shardings=ep)
    assert torch.equal(l1, l2)


def test_lm_train_step_with_ep_mesh_equals_unsharded(one_rank):
    cfg, params, tokens = _lm()
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    out = []
    for ms in (None, _ep(one_rank)):
        opt = topt.AdamW(lr=1e-3)
        step = tsteps.make_lm_train_step(cfg, opt, compute_dtype=None,
                                         moe_shardings=ms)
        p, _, aux = step(params, opt.init(params), batch)
        out.append((aux["loss"], tree_leaves(p)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_constraints_over_one_rank_change_nothing(one_rank):
    cfg, params, tokens = _lm()
    mesh = one_rank
    NS = tshd.NamedSharding
    act = NS(mesh, tshd.P("data", None, "model"))
    tp = {"xs": NS(mesh, tshd.P(None, "data", None)),
          "h": NS(mesh, tshd.P(None, "data", "model")),
          "flat": NS(mesh, tshd.P(("data", "model"), None)),
          "tokens": NS(mesh, tshd.P("data", None))}
    a = tT.forward(params, tokens, cfg, compute_dtype=None, remat=False)
    b = tT.forward(params, tokens, cfg, compute_dtype=None, remat=False,
                   act_constraint=act, moe_shardings=tp)
    assert torch.equal(a, b)


def test_overlap_flags_sets_no_knob():
    assert overlap_flags() == {}
