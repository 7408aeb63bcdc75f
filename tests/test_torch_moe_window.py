"""Tensor-parallel experts compute only their own slots.

``transformer.moe_ffn``'s tensor-parallel branch ranks the capacity over
every data rank's assignments (the reference's global view) but holds
and computes, for each expert, only a window of ``min(c, T)`` slots of
this rank's tokens (``_window_dest``): a rank's assignments to an expert
take consecutive global ranks after those of the data ranks before it,
the ones below the capacity are kept, and a token's k experts are
distinct, so no more than T of them reach one expert.

- On one rank the window of ``c <= T`` slots is today's slot layout bit
  for bit (``_slot_dest``), and the TP branch on a (1, 1) mesh is
  ``torch.equal`` to the unsharded ``moe_ffn``.
- On gloo ranks (mixtral-smoke's layer, 4 experts, top 2): on (2, 2)
  (capacity factor 1.25: the global capacity 60 above a rank's 48
  tokens, so the window is 48) and on (4, 1) (factor 0.75: capacity 36
  against 24 tokens a rank, and assignments dropped), the experts run
  over [E, min(c, T)] slots; the kept assignments are exactly those
  whose global rank, in rank order over the whole batch, is below the
  capacity; outputs and gradients (of the tokens, the router and each
  rank's block of the expert stacks, summed over `data`) are within
  ``rtol=1e-5, atol=1e-6`` of the port's unsharded ``moe_ffn`` and of
  the reference's on the whole batch.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as tshd
from repro_torch.launch.local import run_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tT

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_tp_workers as W  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
ARCH, TOKENS = "mixtral-8x7b", 96
# name: (mesh, capacity factor)
CASES = {"2x2": ((2, 2), 1.25), "4x1": ((4, 1), 0.75)}
KEYS = ("router", "w_gate", "w_up", "w_down")


def inputs(cf):
    """(reference config, port config, layer 0's MoE leaves, tokens x,
    cotangent), numpy, seeded."""
    from repro.configs import get_arch as jax_get_arch

    jcfg = dataclasses.replace(jax_get_arch(ARCH).smoke,
                               capacity_factor=cf)
    tcfg = dataclasses.replace(get_arch(ARCH).smoke, capacity_factor=cf)
    params = tT.init_params(tcfg, torch.Generator().manual_seed(5), "cpu")
    layer = {k: params["layers"][k][0].numpy() for k in KEYS}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((TOKENS, tcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    return jcfg, tcfg, layer, x, ct


def global_keep(tcfg, layer, x) -> np.ndarray:
    """[T, k]: whether each assignment's rank among the earlier ones to
    its expert over the whole batch is below the global capacity."""
    with torch.no_grad():
        _, topi = tT.moe_route(torch.from_numpy(x),
                               torch.from_numpy(layer["router"]),
                               tcfg.top_k)
    e_flat = topi.reshape(-1).numpy()
    c = int(np.ceil(x.shape[0] * tcfg.top_k / tcfg.n_experts
                    * tcfg.capacity_factor))
    seen = np.zeros(tcfg.n_experts, np.int64)
    keep = np.zeros(e_flat.shape, bool)
    for i, j in enumerate(e_flat):
        keep[i] = seen[j] < c
        seen[j] += 1
    return keep.reshape(topi.shape)


def unsharded(tcfg, layer, x, ct):
    """The port's ``moe_ffn`` on the whole batch: output, dx, grads."""
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in layer.items()}
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y = tT.moe_ffn(xt, p, tcfg)
    (y * torch.from_numpy(ct)).sum().backward()
    return (y.detach().numpy(), xt.grad.numpy(),
            {k: v.grad.numpy() for k, v in p.items()})


def reference(jcfg, layer, x, ct):
    """The reference's ``moe_ffn`` on the whole batch and its
    ``jax.grad``: output, dx, grads."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jT

    def f(xx, p):
        y = jT.moe_ffn(xx, p, jcfg)
        return jnp.sum(y * jnp.asarray(ct)), y
    (_, y), (dx, grads) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()})
    return (np.asarray(y), np.asarray(dx),
            {k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: per-rank results}: both meshes' cases in one spawn of 4
    gloo ranks."""
    todo = []
    for shape, cf in CASES.values():
        _, tcfg, layer, x, ct = inputs(cf)
        todo.append(("moe_window_worker", (shape, tcfg, layer, x, ct)))
    res = run_ranks(W.jobs, 4, todo, backend="gloo",
                    store_dir=str(tmp_path_factory.mktemp("window")),
                    timeout_s=180.0)
    return {name: [r[i] for r in res] for i, name in enumerate(CASES)}


def _assemble(res, shape, key):
    """The whole batch's rows from the ranks at model coordinate 0."""
    return np.concatenate([res[d * shape[1]][key] for d in range(shape[0])])


def _model_block(g, key, m, n_m):
    """Model rank ``m``'s block of an expert stack's gradient."""
    if key in ("w_gate", "w_up"):
        f = g.shape[-1] // n_m
        return g[:, :, m * f:(m + 1) * f]
    if key == "w_down":
        f = g.shape[1] // n_m
        return g[:, m * f:(m + 1) * f]
    return g


@pytest.mark.parametrize("name", list(CASES))
def test_experts_run_over_a_window_of_the_ranks_tokens(name, runs):
    shape, cf = CASES[name]
    _, tcfg, _, x, _ = inputs(cf)
    t = TOKENS // shape[0]
    for r in runs[name]:
        c = r["capacity"]
        assert c > t        # the window is smaller than the capacity
        assert r["window"] == [(tcfg.n_experts, min(c, t))]


@pytest.mark.parametrize("name", list(CASES))
def test_kept_assignments_are_the_global_ranks_below_capacity(name, runs):
    shape, cf = CASES[name]
    _, tcfg, layer, x, _ = inputs(cf)
    want = global_keep(tcfg, layer, x)
    got = _assemble(runs[name], shape, "keep")
    np.testing.assert_array_equal(got, want)
    if name == "4x1":
        assert not want.all()        # the capacity drops assignments


@pytest.mark.parametrize("oracle", ["unsharded", "reference"])
@pytest.mark.parametrize("name", list(CASES))
def test_outputs_and_gradients_match(name, oracle, runs):
    shape, cf = CASES[name]
    jcfg, tcfg, layer, x, ct = inputs(cf)
    y, dx, grads = (unsharded(tcfg, layer, x, ct) if oracle == "unsharded"
                    else reference(jcfg, layer, x, ct))
    res = runs[name]
    np.testing.assert_allclose(_assemble(res, shape, "y"), y, **TOL)
    np.testing.assert_allclose(_assemble(res, shape, "dx"), dx, **TOL)
    for rank, r in enumerate(res):
        m = rank % shape[1]
        for k in KEYS:
            np.testing.assert_allclose(
                r["grads"][k], _model_block(grads[k], k, m, shape[1]),
                err_msg=k, **TOL)


@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0, 2.5])
def test_window_is_todays_slots_on_one_rank(cf):
    """``c <= T``: the window layout is ``_slot_dest``'s, bit for bit;
    ``c > T``: the same assignments kept, each at its rank in a window
    of T slots."""
    gen = torch.Generator().manual_seed(11)
    t, e, k = 40, 4, 2
    topi = torch.stack([torch.randperm(e, generator=gen)[:k]
                        for _ in range(t)])
    c = int(np.ceil(t * k / e * cf))
    if c <= t:
        want = tT._slot_dest(topi.reshape(-1), c, 0, e)
        got = tT._window_dest(topi.reshape(-1), c, min(c, t), e)
        assert torch.equal(got, want)
    else:           # c > T on one rank: the same kept slots, a T window
        got = tT._window_dest(topi.reshape(-1), c, t, e)
        want = tT._slot_dest(topi.reshape(-1), c, 0, e)
        kept = want != e * c
        assert torch.equal(got != e * t, kept)
        assert torch.equal(got[kept] % t, want[kept] % c)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    store = tmp_path_factory.mktemp("window1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_one_rank_tp_branch_is_bitwise_the_unsharded(cf, one_rank):
    _, tcfg, layer, x, _ = inputs(cf)
    p = {k: torch.from_numpy(v) for k, v in layer.items()}
    xt = torch.from_numpy(x)
    got = tT.moe_ffn(xt, p, tcfg,
                     shardings=tshd.tp_expert_shardings(one_rank))
    assert torch.equal(got, tT.moe_ffn(xt, p, tcfg))
