"""The port's factorization machine against the JAX reference.

The reference's FM parameters (carried with ``convert.tree_from_numpy``)
and the same click batches go through ``repro.models.fm`` /
``repro.train.steps`` and their ports at float32 on the CPU: scores, the
loss and its gradient, retrieval, one AdamW train step, and the click
stream. ``TOL`` (``rtol=1e-4, atol=1e-5``) holds everywhere: each score
sums at most F·k products of embeddings of size 0.01.

JAX is imported only inside the CPU tests, so the ``cuda`` tests run
where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import tree_from_numpy
from repro_torch.data import ClickStream
from repro_torch.models import fm as tfm
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
CFG = get_arch("fm").smoke


def _params(seed=0):
    """(reference params, the same numbers as port tensors)."""
    import jax
    from repro.models import fm as jfm
    from repro.configs import get_arch as jax_get_arch
    p = jfm.fm_init(jax_get_arch("fm").smoke, jax.random.PRNGKey(seed))
    return p, tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               **tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scores_match_the_reference_and_the_pairwise_oracle(seed):
    import jax.numpy as jnp
    from repro.models import fm as jfm

    jp, tp = _params(seed)
    idx = ClickStream(CFG.vocab_sizes, 64, seed=seed).batch_at(0)["idx"]
    want = jfm.fm_score(jp, jnp.asarray(idx), CFG)
    got = tfm.fm_score(tp, torch.from_numpy(idx), CFG)
    _close(got, want)
    _close(tfm.fm_score_ref(tp, idx, CFG), want)
    np.testing.assert_array_equal(tfm.field_offsets(CFG),
                                  jfm.field_offsets(CFG))


def test_loss_and_its_gradient_match_the_reference():
    """The stable BCE and its gradient in every leaf (``w0`` too); the
    gradient of the tables is summed per row by plan."""
    import jax
    import jax.numpy as jnp
    from repro.models import fm as jfm

    jp, tp = _params(3)
    batch = ClickStream(CFG.vocab_sizes, 128, seed=4).batch_at(2)
    jl, jg = jax.value_and_grad(jfm.fm_loss)(
        jp, jnp.asarray(batch["idx"]), jnp.asarray(batch["labels"]), CFG)
    tl, tg = tsteps.value_and_grad(
        lambda p, b: tfm.fm_loss(p, b["idx"], b["labels"], CFG), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl)
    for k in ("v", "w", "w0"):
        _close(tg[k], jg[k])


def test_retrieval_matches_the_reference_and_the_direct_scores():
    """One user's 3 fields against 50 candidates: the decomposed score
    equals the reference's and each candidate's direct ``fm_score``."""
    import jax.numpy as jnp
    from repro.models import fm as jfm

    jp, tp = _params(5)
    rng = np.random.default_rng(1)
    n_user, m = 3, 50
    raw = rng.integers(0, 10, (m, CFG.n_sparse)).astype(np.int32)
    raw[:, :n_user] = raw[0, :n_user]
    flat = raw + tfm.field_offsets(CFG)[None, :]
    user, cand = flat[0, :n_user], flat[:, n_user:]
    want = jfm.retrieval_score(jp, jnp.asarray(user), jnp.asarray(cand), CFG,
                               n_user)
    step = tsteps.make_fm_retrieval_step(CFG, n_user)
    got = step(tp, torch.from_numpy(user), torch.from_numpy(cand))
    assert not got.requires_grad
    _close(got, want)
    _close(got, tfm.fm_score(tp, raw, CFG).detach())


def test_train_step_matches_the_reference():
    """One ``make_fm_train_step`` with AdamW: the loss, its gradients
    (read through ``compress``), the new params and the AdamW state."""
    import jax
    import jax.numpy as jnp
    from repro.models import fm as jfm
    from repro.train import optimizer as jopt

    jp, tp = _params(6)
    batch = ClickStream(CFG.vocab_sizes, 256, seed=7).batch_at(0)
    jl, jg = jax.value_and_grad(jfm.fm_loss)(
        jp, jnp.asarray(batch["idx"]), jnp.asarray(batch["labels"]), CFG)
    jo = jopt.AdamW(lr=1e-3)
    jp2, js2 = jo.update(jg, jo.init(jp), jp)

    to = topt.AdamW(lr=1e-3)
    seen = []
    step = tsteps.make_fm_train_step(CFG, to,
                                     compress=lambda g: seen.append(g) or g)
    tp2, ts2, m = step(tp, to.init(tp),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(m["loss"], jl)
    for port, ref in ((seen[0], jg), (tp2, jp2), (ts2, js2)):
        a, b = tree_leaves(port), jax.tree_util.tree_leaves(ref)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)


def test_serve_step_records_no_gradient():
    _, tp = _params(8)
    idx = ClickStream(CFG.vocab_sizes, 16, seed=9).batch_at(0)["idx"]
    leaves = {k: v.requires_grad_(True) if v.is_floating_point() else v
              for k, v in tp.items()}
    out = tsteps.make_fm_serve_step(CFG)(leaves, {"idx": idx})
    assert out.shape == (16,) and not out.requires_grad


def test_init_shapes_and_draws():
    p = tfm.fm_init(CFG, torch.Generator().manual_seed(0), device="cpu")
    total = sum(CFG.vocab_sizes)
    assert p["v"].shape == (total, CFG.embed_dim)
    assert p["w"].shape == (total, 1) and p["w0"].shape == ()
    assert 0.005 < float(p["v"].std()) < 0.015


@pytest.mark.parametrize("step", [0, 3])
def test_click_stream_equals_the_references(step):
    from repro.data.recsys import ClickStream as JaxClickStream
    full = get_arch("fm").config.vocab_sizes
    want = JaxClickStream(full, 512, seed=2).batch_at(step)
    got = ClickStream(full, 512, seed=2).batch_at(step)
    for k in ("idx", "labels"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


@pytest.mark.cuda
def test_card_fm_train_steps_rerun_bitwise():
    """Three AdamW steps on the card, twice from the same state: the
    same losses and tables bit for bit (the tables' gradient is summed
    per row by plan, with no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tfm.fm_init(CFG, gen, device="cuda")
    opt = topt.AdamW(lr=1e-2)
    step = tsteps.make_fm_train_step(CFG, opt)
    stream = ClickStream(CFG.vocab_sizes, 4096, seed=1)
    runs = []
    for _ in range(2):
        p, s, out = params, opt.init(params), []
        for i in range(3):
            p, s, m = step(p, s, {k: torch.from_numpy(v).cuda()
                                  for k, v in stream.batch_at(i).items()})
            out.append(m["loss"])
        runs.append(out + tree_leaves(p))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
