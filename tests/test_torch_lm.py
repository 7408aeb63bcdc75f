"""The port's language-model family against the JAX reference.

The same numpy inputs and weights (the reference's, carried with
``convert.tree_from_numpy``) go through ``repro.models.{attention,
transformer}`` / ``repro.train.steps`` and their ports, at float32
(``compute_dtype=None``) on the CPU, for every LM smoke config:
chunked attention and its gradients, MoE routing and dispatch, the
chunked cross-entropy, forward / prefill / decode with their caches, a
train step with AdamW, a bf16 forward, and the token stream.

Tolerances (float32, the two packages sum in other orders): ``TOL``
(``rtol=1e-4, atol=1e-5``) for activations, logits, caches and
gradients; ``STEP_TOL`` for parameters after an AdamW step, whose first
update is about ``lr * g / (|g| + eps)`` (an entry whose gradient is 0
up to rounding moves by at most ``lr * |dg| / eps``); ``BF16_TOL`` for
bf16 compute, where each rounding to bf16 keeps 8 bits.

JAX is imported only inside the CPU tests, so the ``cuda`` tests run
where JAX is not installed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import tree_from_numpy
from repro_torch.data import TokenStream
from repro_torch.models import transformer as tt
from repro_torch.models.attention import chunked_attention
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 forward: |port - ref| <= 5e-2 * max|ref| (a few bf16 ulps of the
# logits after two layers of bf16 products and roundings)
BF16_TOL = 5e-2
ARCHS = ["mixtral-8x7b", "qwen3-moe-235b-a22b", "granite-8b", "qwen3-0.6b",
         "smollm-360m"]


def _cfgs(arch, **kw):
    """(reference config, port config) of ``arch``'s smoke config, with
    ``kw`` replaced in both."""
    from repro.configs import get_arch as jax_get_arch
    return (dataclasses.replace(jax_get_arch(arch).smoke, **kw),
            dataclasses.replace(get_arch(arch).smoke, **kw))


def _params(jcfg, seed=0):
    """(reference params as jax arrays, the same numbers as port tensors)."""
    import jax
    from repro.models import transformer as jt
    p = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    return p, tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               **tol)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


# --------------------------------------------------------- attention ----
ATTN_CASES = {
    # (b, s, t, kv, g, d, window, q_chunk, k_chunk, ring)
    "causal": (2, 29, 29, 2, 3, 8, None, 7, 5, False),
    "window": (2, 37, 37, 2, 2, 8, 9, 8, 6, False),
    "mha_one_chunk": (1, 12, 12, 4, 1, 16, None, 64, 64, False),
    "gqa_wide_group": (2, 19, 19, 1, 4, 8, 6, 5, 4, False),
    "ring_decode": (3, 1, 24, 2, 3, 8, 10, 1, 7, True),
    "ring_block": (2, 5, 20, 2, 2, 8, None, 2, 6, True),
}


def _attn_inputs(case, seed):
    b, s, t, kv, g, d, window, qc, kc, ring = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, kv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=qc, k_chunk=kc)
    if ring:
        # a ring buffer: absolute positions in rotated slots, some slots
        # not yet written (kv_valid False), queries after the cache
        n = 30
        kv_pos = np.stack([np.roll(np.arange(n - t, n), int(r))
                           for r in rng.integers(0, t, b)]).astype(np.int32)
        kv_valid = rng.random((b, t)) < 0.8
        kv_valid[:, 0] = True
        q_pos = np.arange(n - s + 1, n + 1).astype(np.int32)
        kw.update(kv_valid=kv_valid)
    else:
        q_pos = kv_pos = np.arange(s).astype(np.int32)
    return q, k, v, q_pos, kv_pos, kw


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_attention_and_its_gradients_match_the_reference(name):
    """Output and the q, k, v gradients against ``jax.vjp`` of the
    reference's custom VJP."""
    import jax
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention as jatt

    q, k, v, q_pos, kv_pos, kw = _attn_inputs(ATTN_CASES[name], seed=3)
    jkw = dict(kw)
    if "kv_valid" in jkw:
        jkw["kv_valid"] = jnp.asarray(jkw["kv_valid"])

    def ref(q, k, v):
        return jatt(q, k, v, q_pos=jnp.asarray(q_pos),
                    kv_pos=jnp.asarray(kv_pos), **jkw)

    want, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
    g_out = np.random.default_rng(4).standard_normal(want.shape).astype(
        np.float32)
    dq, dk, dv = vjp(jnp.asarray(g_out))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tkw = dict(kw)
    if "kv_valid" in tkw:
        tkw["kv_valid"] = torch.from_numpy(tkw["kv_valid"])
    out = chunked_attention(tq, tk, tv, q_pos=torch.from_numpy(q_pos),
                            kv_pos=torch.from_numpy(kv_pos), **tkw)
    out.backward(torch.from_numpy(g_out))
    _close(out, want)
    for got, ref_g in ((tq, dq), (tk, dk), (tv, dv)):
        _close(got.grad, ref_g)


def test_attention_head_h_reads_kv_head_h_over_g():
    """GQA layout: q head h attends with kv head h // G (a naive
    per-head softmax attention, no chunks)."""
    b, s, kv, g, d = 1, 6, 2, 3, 4
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, s, kv * g, d)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, kv, d)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, kv, d)).astype(
        np.float32))
    pos = torch.arange(s)
    out = chunked_attention(q, k, v, q_pos=pos, kv_pos=pos, q_chunk=4,
                            k_chunk=4)
    causal = pos[None, :] <= pos[:, None]
    for h in range(kv * g):
        sc = q[0, :, h] @ k[0, :, h // g].T / np.sqrt(d)
        p = torch.softmax(sc.masked_fill(~causal, -1e30), -1)
        torch.testing.assert_close(out[0, :, h], p @ v[0, :, h // g],
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- MoE ----
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("capacity", ["no_drops", "default", "one"])
def test_moe_routing_and_dispatch_match_the_reference(arch, capacity):
    """The router's top-k experts equal the reference's (checked first,
    so a routing flip is reported as one), then the dispatch output:
    without drops, at the config's capacity factor, and at capacity 1
    (most assignments dropped)."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jt

    cf = 50.0 if capacity == "no_drops" else get_arch(arch).smoke \
        .capacity_factor
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    lp = jt.init_layer_params(jcfg, jax.random.PRNGKey(5))
    x = np.random.default_rng(6).standard_normal(
        (32, jcfg.d_model)).astype(np.float32)
    cap = 1 if capacity == "one" else None
    tlp = tree_from_numpy(jax.tree.map(np.asarray, lp), "cpu")

    probs = jax.nn.softmax(jnp.asarray(x) @ lp["router"], axis=-1)
    _, want_i = jax.lax.top_k(probs, jcfg.top_k)
    _, got_i = tt.moe_route(torch.from_numpy(x), tlp["router"], tcfg.top_k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))

    want = jt.moe_ffn(jnp.asarray(x), lp, jcfg, capacity=cap)
    got = tt.moe_ffn(torch.from_numpy(x), tlp, tcfg, capacity=cap)
    _close(got, want)
    assert bool(torch.isfinite(got).all())


def test_moe_drops_change_the_output():
    _, tcfg = _cfgs("mixtral-8x7b", capacity_factor=50.0)
    lp = tt.init_layer_params(tcfg, torch.Generator().manual_seed(0))
    x = torch.randn(32, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    full = tt.moe_ffn(x, lp, tcfg)
    tight = tt.moe_ffn(x, lp, tcfg, capacity=1)
    assert float((full - tight).abs().max()) > 1e-3


# ----------------------------------------------------- cross-entropy ----
@pytest.mark.parametrize("b,s,chunk", [(3, 17, 5), (1, 1, 4), (2, 8, 8),
                                       (4, 30, 7), (2, 9, 64)])
def test_chunked_xent_and_its_gradient_match_the_reference(b, s, chunk):
    import jax
    import jax.numpy as jnp
    from repro.train.steps import chunked_cross_entropy as jxent

    rng = np.random.default_rng(b * 100 + s)
    d, v = 6, 29
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    head = rng.standard_normal((d, v)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, 0] = -1                              # an unlabelled token
    want, (gh, ghead) = jax.value_and_grad(
        lambda h, w: jxent(h, w, jnp.asarray(labels), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    th, tw = (torch.tensor(x, requires_grad=True) for x in (h, head))
    got = tsteps.chunked_cross_entropy(th, tw, torch.from_numpy(labels),
                                       chunk=chunk)
    got.backward()
    _close(got, want)
    _close(th.grad, gh)
    _close(tw.grad, ghead)


# ------------------------------------------ forward, prefill, decode ----
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_the_reference(arch):
    """Logits of ``forward``, the cache of ``prefill`` (k, v, positions,
    index) and the logits and cache of the next ``decode_step``; and
    decode's logits equal the forward's last position (the reference's
    own check)."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jt

    kw = dict(capacity_factor=8.0) if get_arch(arch).smoke.moe else {}
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg)
    s = 24
    toks = _tokens(jcfg, 2, s)
    want = jax.jit(lambda p, t: jt.logits_fn(p, jt.forward(
        p, t, jcfg, remat=False, q_chunk=8, k_chunk=8, compute_dtype=None),
        jcfg))(jp, jnp.asarray(toks))
    th = tt.forward(tp, torch.from_numpy(toks), tcfg, remat=False,
                    q_chunk=8, k_chunk=8, compute_dtype=None)
    got = tt.logits_fn(tp, th, tcfg)
    _close(got, want)

    pkw = dict(max_len=s + 4, q_chunk=8, k_chunk=8, compute_dtype=None)
    jh_p, jcache = jax.jit(lambda p, t: jt.prefill(
        p, t, jcfg, cache_dtype=jnp.float32, **pkw))(
            jp, jnp.asarray(toks[:, :s - 1]))
    th_p, tcache = tt.prefill(tp, torch.from_numpy(toks[:, :s - 1]), tcfg,
                              cache_dtype=torch.float32, **pkw)
    _close(th_p, jh_p)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    for key in ("pos", "index"):
        assert tcache[key].dtype == torch.int32
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))

    jlg, jnext = jax.jit(lambda p, c, t: jt.decode_step(
        p, c, t, jcfg, compute_dtype=None))(jp, jcache,
                                            jnp.asarray(toks[:, s - 1:]))
    tlg, tnext = tt.decode_step(tp, tcache, torch.from_numpy(
        toks[:, s - 1:]), tcfg, compute_dtype=None)
    _close(tlg, jlg)
    for key in ("k", "v"):
        _close(tnext[key], jnext[key])
    for key in ("pos", "index"):
        np.testing.assert_array_equal(tnext[key].numpy(),
                                      np.asarray(jnext[key]))
    assert float((tlg[:, 0] - got[:, s - 1]).abs().max()) < 5e-5


def test_swa_prefill_past_the_window_then_decode():
    """mixtral smoke (window 16): a 21-token prompt fills the 16-slot
    ring through ``prefill``'s roll (shift 5), then 6 decode steps;
    caches and logits equal the reference's, and each decode's logits
    equal the windowed forward's at its position."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jt

    jcfg, tcfg = _cfgs("mixtral-8x7b", capacity_factor=8.0)
    jp, tp = _params(jcfg, seed=2)
    jdecode = jax.jit(lambda p, c, t: jt.decode_step(p, c, t, jcfg,
                                                     compute_dtype=None))
    s, n_dec = 21, 6
    toks = _tokens(jcfg, 2, s + n_dec, seed=3)
    pkw = dict(max_len=s + n_dec, q_chunk=8, k_chunk=8, compute_dtype=None)
    _, jcache = jt.prefill(jp, jnp.asarray(toks[:, :s]), jcfg,
                           cache_dtype=jnp.float32, **pkw)
    _, tcache = tt.prefill(tp, torch.from_numpy(toks[:, :s]), tcfg,
                           cache_dtype=torch.float32, **pkw)
    assert tcache["k"].shape[2] == jcfg.sliding_window
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    th = tt.forward(tp, torch.from_numpy(toks), tcfg, remat=False,
                    q_chunk=8, k_chunk=8, compute_dtype=None)
    full = tt.logits_fn(tp, th, tcfg)
    for i in range(n_dec):
        tok = toks[:, s + i:s + i + 1]
        jlg, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        tlg, tcache = tt.decode_step(tp, tcache, torch.from_numpy(tok),
                                     tcfg, compute_dtype=None)
        _close(tlg, jlg)
        _close(tcache["k"], jcache["k"])
        assert float((tlg[:, 0] - full[:, s + i]).abs().max()) < 1e-4


def test_decode_consumes_its_cache_in_place():
    """``decode_step`` writes the new slot into the cache it is given
    and returns the same k / v / pos tensors; the logits are those of a
    decode on a copy."""
    _, tcfg = _cfgs("qwen3-0.6b")
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, 2, 9))
    _, cache = tt.prefill(tp, toks[:, :8], tcfg, max_len=12,
                          cache_dtype=torch.float32, compute_dtype=None)
    copy = {k: v.clone() for k, v in cache.items()}
    lg, new = tt.decode_step(tp, cache, toks[:, 8:], tcfg,
                             compute_dtype=None)
    lg_copy, new_copy = tt.decode_step(tp, copy, toks[:, 8:], tcfg,
                                       compute_dtype=None)
    for key in ("k", "v", "pos"):
        assert new[key] is cache[key]
        assert torch.equal(new[key], new_copy[key])
    assert int(new["index"]) == 9 and int(cache["index"]) == 8
    assert torch.equal(lg, lg_copy)
    assert int((cache["pos"] >= 0).sum()) == 2 * 9


def test_layer_modes_and_remat_agree():
    """"scan" and "unroll" are one loop; remat recomputes each layer in
    the backward and gives the same loss and gradients."""
    _, tcfg = _cfgs("qwen3-moe-235b-a22b")
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(1),
                        device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             TokenStream(tcfg.vocab, 2, 16, seed=3).batch_at(0).items()}
    runs = []
    for mode, remat in (("scan", False), ("unroll", False), ("scan", True)):
        loss, grads = tsteps.value_and_grad(
            lambda p, b: tsteps.lm_loss(p, b, tcfg, remat=remat, q_chunk=8,
                                        k_chunk=8, xent_chunk=8,
                                        layer_mode=mode,
                                        compute_dtype=None), tp, batch)
        runs.append([loss] + tree_leaves(grads))
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    with pytest.raises(ValueError):
        tt.forward(tp, batch["tokens"], tcfg, layer_mode="vmap")


def _two_model_ranks(spec):
    import types

    from repro_torch.distributed.sharding import NamedSharding, P
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                 axis_names=("data", "model"))
    return NamedSharding(mesh, P(*spec))


@pytest.mark.parametrize("kw, match", [
    (dict(moe_shardings={"xs": ("model", None, None)}),
     "tensor-parallel MoE dict needs"),
    (dict(act_constraint=(None, None, "model")),
     "keeps the residual stream")], ids=["kw0", "kw1"])
def test_sharded_execution_is_the_distributed_slices(kw, match):
    """Sharded execution runs over process groups (tensor-parallel and
    FSDP execution of the LM: tests/test_torch_tp.py). Before any
    collective, a tensor-parallel MoE dict without its four constraints
    and a residual constraint other than the strategy's layout
    (``P(dp, model, None)`` under "tp_fsdp") are refused."""
    _, tcfg = _cfgs("mixtral-8x7b")
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    kw = {k: ({n: _two_model_ranks(s) for n, s in v.items()}
              if isinstance(v, dict) else _two_model_ranks(v))
          for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        tt.forward(tp, torch.zeros((1, 4), dtype=torch.long), tcfg, **kw)


# -------------------------------------------------------- train step ----
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_matches_the_reference(arch):
    """One ``make_lm_train_step`` (AdamW, warmup-cosine, clipping) at
    f32: its loss, its gradients (read through ``compress``) and the
    updated params and AdamW state against ``jax.value_and_grad`` of the
    reference's f32 LM loss and the reference's AdamW."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jt
    from repro.train import optimizer as jopt
    from repro.train.steps import chunked_cross_entropy as jxent

    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=4)
    batch = TokenStream(jcfg.vocab, 2, 16, seed=5).batch_at(0)
    fkw = dict(q_chunk=8, k_chunk=8)

    def jloss(p):
        h = jt.forward(p, jnp.asarray(batch["tokens"]), jcfg, remat=True,
                       compute_dtype=None, **fkw)
        return jxent(h, p["lm_head"], jnp.asarray(batch["labels"]),
                     chunk=8)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    jo = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10), weight_decay=0.01)
    jp2, js2 = jax.jit(jo.update)(jg, jo.init(jp), jp)

    seen = []
    to = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10), weight_decay=0.01)
    step = tsteps.make_lm_train_step(
        tcfg, to, xent_chunk=8, compute_dtype=None,
        compress=lambda g: seen.append(g) or g, **fkw)
    tp2, ts2, metrics = step(tp, to.init(tp), {
        k: torch.from_numpy(v) for k, v in batch.items()})
    _close(metrics["loss"], jl)
    pairs = [(tree_leaves(seen[0]), jax.tree_util.tree_leaves(jg), TOL),
             (tree_leaves(tp2), jax.tree_util.tree_leaves(jp2), STEP_TOL),
             (tree_leaves(ts2), jax.tree_util.tree_leaves(js2), STEP_TOL)]
    for port, ref, tol in pairs:
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _close(a, b, tol)


def test_bf16_forward_is_close_to_the_references():
    """bf16 compute (the default) against the reference's bf16 forward,
    and the bf16 train loss against the reference's
    ``make_lm_train_step``'s, within ``BF16_TOL`` of their size."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jt
    from repro.train import optimizer as jopt
    from repro.train import steps as jsteps

    jcfg, tcfg = _cfgs("qwen3-0.6b")
    jp, tp = _params(jcfg, seed=6)
    toks = _tokens(jcfg, 2, 16, seed=7)
    want = jax.jit(lambda p, t: jt.logits_fn(p, jt.forward(
        p, t, jcfg, q_chunk=8, k_chunk=8), jcfg))(jp, jnp.asarray(toks))
    got = tt.logits_fn(tp, tt.forward(tp, torch.from_numpy(toks), tcfg,
                                      q_chunk=8, k_chunk=8), tcfg)
    assert got.dtype == torch.float32    # final norm's f32 scale promotes
    err = float(np.abs(got.detach().numpy() - np.asarray(want)).max())
    assert err <= BF16_TOL * float(np.abs(np.asarray(want)).max()), err

    batch = TokenStream(jcfg.vocab, 2, 16, seed=8).batch_at(0)
    jstep = jsteps.make_lm_train_step(jcfg, jopt.AdamW(lr=1e-3), q_chunk=8,
                                      k_chunk=8, xent_chunk=8)
    _, _, jm = jax.jit(jstep)(jp, jopt.AdamW(lr=1e-3).init(jp),
                              jax.tree.map(jnp.asarray, batch))
    to = topt.AdamW(lr=1e-3)
    tstep = tsteps.make_lm_train_step(tcfg, to, q_chunk=8, k_chunk=8,
                                      xent_chunk=8)
    _, _, tm = tstep(tp, to.init(tp),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= BF16_TOL * float(
        jm["loss"])


def test_prefill_and_decode_steps_match_the_references():
    """``make_lm_prefill_step`` / ``make_lm_decode_step`` (bf16 compute
    and cache, as the reference's) give the reference's steps'
    last-position and next-token logits within ``BF16_TOL`` of their
    size, record no gradient, and advance the cache."""
    import jax
    import jax.numpy as jnp
    from repro.train import steps as jsteps

    jcfg, tcfg = _cfgs("granite-8b")
    jp, tp = _params(jcfg, seed=9)
    toks = _tokens(jcfg, 2, 12, seed=10)
    kw = dict(max_len=16, q_chunk=4, k_chunk=4)
    jlg, jcache = jax.jit(jsteps.make_lm_prefill_step(jcfg, **kw))(
        jp, jnp.asarray(toks[:, :11]))
    jnext, _ = jax.jit(jsteps.make_lm_decode_step(jcfg))(
        jp, jcache, jnp.asarray(toks[:, 11:]))
    tlg, tcache = tsteps.make_lm_prefill_step(tcfg, **kw)(
        tp, torch.from_numpy(toks[:, :11]))
    tnext, tcache = tsteps.make_lm_decode_step(tcfg)(
        tp, tcache, torch.from_numpy(toks[:, 11:]))
    assert tlg.shape == tuple(jlg.shape) == (2, 1, jcfg.vocab)
    assert not tlg.requires_grad and int(tcache["index"]) == 12
    for got, want in ((tlg, jlg), (tnext, jnext)):
        want = np.asarray(want, np.float32)
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= BF16_TOL * float(np.abs(want).max()), err


# -------------------------------------------------------------- data ----
@pytest.mark.parametrize("step", [0, 7])
def test_token_stream_equals_the_references(step):
    from repro.data.tokens import TokenStream as JaxTokenStream
    want = JaxTokenStream(151936, 3, 33, seed=11).batch_at(step)
    got = TokenStream(151936, 3, 33, seed=11).batch_at(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


# -------------------------------------------------------------- card ----
def _card_model(arch="qwen3-moe-235b-a22b"):
    cfg = get_arch(arch).smoke
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, tt.init_params(cfg, gen, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "qwen3-0.6b"])
def test_card_train_steps_rerun_bitwise(arch):
    """Three bf16 train steps on the card, twice from the same state:
    the same loss and parameters bit for bit (the embedding and MoE
    gathers and sums follow host plans; no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, params = _card_model(arch)
    opt = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))
    step = tsteps.make_lm_train_step(cfg, opt, q_chunk=16, k_chunk=16,
                                     xent_chunk=16)
    stream = TokenStream(cfg.vocab, 2, 64, seed=0)
    runs = []
    for _ in range(2):
        p, s, losses = params, opt.init(params), []
        for i in range(3):
            p, s, m = step(p, s, {k: torch.from_numpy(v).cuda()
                                  for k, v in stream.batch_at(i).items()})
            losses.append(m["loss"])
        runs.append(losses + tree_leaves(p))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_decode_equals_forward(arch):
    """On the card at f32: prefill S-1 tokens, decode one; its logits
    equal the forward's last position (the reference's bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, params = _card_model(arch)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    s = 40
    toks = torch.from_numpy(_tokens(cfg, 2, s)).cuda()
    full = tt.logits_fn(params, tt.forward(params, toks, cfg, remat=False,
                                           q_chunk=16, k_chunk=16,
                                           compute_dtype=None), cfg)
    _, cache = tt.prefill(params, toks[:, :s - 1], cfg, max_len=s + 4,
                          q_chunk=16, k_chunk=16, cache_dtype=torch.float32,
                          compute_dtype=None)
    lg, _ = tt.decode_step(params, cache, toks[:, s - 1:], cfg,
                           compute_dtype=None)
    assert float((lg[:, 0] - full[:, s - 1]).abs().max()) < 5e-5
