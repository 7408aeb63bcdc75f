"""The port's error-feedback gradient compression against the reference.

``repro_torch.distributed.collectives`` quantizes each gradient leaf to
int8 with a per-tensor scale and carries the quantization error into
the next step (EF-SGD). On the same float32 inputs its codes, scales,
dequantized values and residuals must be the reference's bits
(``torch.round`` and ``jnp.round`` both round half to even). Through a
train step the gradients themselves differ in the last place, so the
params and residuals are held within tolerances there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.distributed import collectives as jcol
from repro.models import fm as jfm
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_arch
from repro_torch.convert import tree_from_numpy
from repro_torch.data import ClickStream
from repro_torch.distributed import collectives as tcol
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)


def _bits(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": [(rng.standard_normal((6, 5)) * 0.01).astype(np.float32),
                  rng.standard_normal(5).astype(np.float32)],
            "t": ((rng.standard_normal((3, 4)) * 1e-4).astype(np.float32),),
            "z": np.zeros((2, 2), np.float32)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_dequantize_bits_equal(seed):
    x = (np.random.default_rng(seed).standard_normal(1000)
         * 10.0 ** (seed - 2)).astype(np.float32)
    jq, js = jcol.quantize_int8(jnp.asarray(x))
    tq, ts = tcol.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _bits(tq, jq)
    _bits(ts, js)
    _bits(tcol.dequantize_int8(tq, ts), jcol.dequantize_int8(jq, js))
    # the round trip is within half a code step
    err = (tq.to(torch.float32) * ts - torch.from_numpy(x)).abs().max()
    assert float(err) <= float(ts) * 0.5 + 1e-7


def test_round_half_to_even_and_all_zero_tensor():
    """max |x| = 127 makes the scale exactly 1, so x / scale lands on
    halves: both round them to even. An all-zero tensor takes the
    1e-12 floor."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5], np.float32)
    tq, ts = tcol.quantize_int8(torch.from_numpy(x))
    assert float(ts) == 1.0
    assert tq.tolist() == [127, 0, 2, 2, 0, -2, -126]
    _bits(tq, jcol.quantize_int8(jnp.asarray(x))[0])
    zq, zs = tcol.quantize_int8(torch.zeros(4))
    _bits(zs, jcol.quantize_int8(jnp.zeros(4))[1])
    assert not zq.any()


def test_three_step_residual_equals_reference():
    params = _grad_tree(10)
    jef = jcol.ef_init(jax.tree.map(jnp.asarray, params))
    tef = tcol.ef_init(tree_from_numpy(params, "cpu"))
    assert all(not r.any() for r in tree_leaves(tef.residual))
    for step in range(3):
        g = _grad_tree(step)
        jg, jef = jcol.compress_with_error_feedback(
            jax.tree.map(jnp.asarray, g), jef)
        tg, tef = tcol.compress_with_error_feedback(
            tree_from_numpy(g, "cpu"), tef)
        assert type(tef) is tcol.EFState
        for port, ref in ((tg, jg), (tef.residual, jef.residual)):
            a, b = tree_leaves(port), jax.tree_util.tree_leaves(ref)
            assert len(a) == len(b) == 4
            for x, y in zip(a, b):
                _bits(x, y)
        assert any(r.any() for r in tree_leaves(tef.residual))
    assert isinstance(tg["t"], tuple) and isinstance(tg["w"], list)


def test_error_feedback_preserves_signal():
    """Sum of compressed gradients ~ sum of true gradients (EF-SGD's
    key invariant: the residual never grows unboundedly)."""
    rng = np.random.default_rng(0)
    g_true = [torch.from_numpy((rng.standard_normal(64) * 0.01).astype(
        np.float32)) for _ in range(50)]
    ef = tcol.ef_init({"w": g_true[0]})
    acc_c = torch.zeros(64)
    for g in g_true:
        cg, ef = tcol.compress_with_error_feedback({"w": g}, ef)
        acc_c = acc_c + cg["w"]
    acc_t = sum(g.numpy() for g in g_true)
    # residual bounded by one quantization step, not accumulating
    assert np.abs(acc_c.numpy() - acc_t).max() < 0.01


def test_fm_train_step_with_compression_matches_reference():
    """Three SGD steps of ``make_fm_train_step`` with an EF compressor
    (a closure holding the ``EFState`` between steps, as a user of the
    reference writes it): the loss and params within ``TOL``, and the
    residuals within 1e-4 of their largest entry, where one int8 code
    of difference would be 1/127 of it."""
    jcfg, cfg = jax_get_arch("fm").smoke, get_arch("fm").smoke
    jp = jfm.fm_init(jcfg, jax.random.PRNGKey(6))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jo, to = jopt.SGD(lr=1e-2), topt.SGD(lr=1e-2)
    ef = {"jax": jcol.ef_init(jp), "port": tcol.ef_init(tp)}

    def jax_compress(g):
        g, ef["jax"] = jcol.compress_with_error_feedback(g, ef["jax"])
        return g

    def port_compress(g):
        g, ef["port"] = tcol.compress_with_error_feedback(g, ef["port"])
        return g

    jstep = jsteps.make_fm_train_step(jcfg, jo, compress=jax_compress)
    tstep = tsteps.make_fm_train_step(cfg, to, compress=port_compress)
    js, ts = jo.init(jp), to.init(tp)
    stream = ClickStream(cfg.vocab_sizes, 256, seed=7)
    for i in range(3):
        batch = stream.batch_at(i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        res = zip(tree_leaves(ef["port"].residual),
                  jax.tree_util.tree_leaves(ef["jax"].residual))
        for a, b in res:
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(b).max()))
    assert any(r.any() for r in tree_leaves(ef["port"].residual))
