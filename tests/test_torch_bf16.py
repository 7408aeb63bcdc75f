"""bfloat16 through the port's plain versions, held against the reference.

The reference's four TPU kernels take bfloat16 operands with a float32
accumulator, and its tri-engine ``hybrid_spmm`` rounds at fixed points: the
dense tiles to B's type, the dense engine's rows to B's type, then the
three engines' rows added in float32 and the result rounded to B's type.
On the CPU the port's wrappers run their plain versions; these are held
against the Pallas kernels run as the JAX tests run them
(``interpret=True``), and the port's ``hybrid_spmm`` / ``gcn_layer`` /
``gcn_forward`` (both backends, every ELL dispatch) against the
reference's ``backend="xla"`` on the reference's edge-case graphs
(``tests/test_torch_dispatch.py`` ``EDGE_CASES``), from numpy seeds.

Tolerances:
  * float32 results (the products of ``bsr_spmm`` and of the ELL kernels,
    a GCN layer whose weights are float32): the reference's own float32
    tolerance, ``rtol=2e-5, atol=2e-4`` (``tests/test_kernels.py:17``);
  * bfloat16 results (``tile_matmul``, ``hybrid_spmm``, ``gcn_forward``):
    elementwise ``|got - ref| <= ulp_bf16(|ref|) + 2e-6 * (|A| @ |B|)``,
    the product of absolute values in float64 (``ref.bf16_tolerance``:
    one bfloat16 rounding apart, plus float32 sums in another order).
Types are checked exactly, and the ELL dispatches must agree bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as rc
import repro_torch.core as tc
from repro.kernels.bsr_spmm import bsr_spmm as jax_bsr
from repro.kernels.ell_spmm import ell_spmm as jax_ell
from repro.kernels.ell_spmm import ragged_ell_spmm as jax_ragged
from repro.kernels.tile_matmul import tile_matmul as jax_matmul
from repro_torch.kernels.bsr_spmm import bsr_spmm
from repro_torch.kernels.ell_spmm import ell_spmm, ragged_ell_spmm
from repro_torch.kernels.ref import bf16_tolerance
from repro_torch.kernels.tile_matmul import tile_matmul

from test_torch_dispatch import EDGE_CASES, _edge
from test_torch_kernels import bsr_inputs, ell_inputs

torch.set_num_threads(2)

F32_TOL = dict(rtol=2e-5, atol=2e-4)
BF16, F32 = torch.bfloat16, torch.float32
TYPES = {"f32": (F32, jnp.float32), "bf16": (BF16, jnp.bfloat16)}
DISPATCHES = ("ragged", "fused", "loop")


def both(x: np.ndarray, kind: str):
    """``x`` as a port tensor and a reference array of type ``kind``
    (the same values: bfloat16 rounds to nearest even in both)."""
    t, j = TYPES[kind]
    return torch.from_numpy(np.ascontiguousarray(x)).to(t), jnp.asarray(x, j)


def as_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def assert_bf16_close(got, want, mag):
    """The bfloat16 bound, elementwise, against the reference's result."""
    w = torch.from_numpy(as_f64(want))
    bound = bf16_tolerance(w, torch.as_tensor(mag)).numpy()
    err = np.abs(as_f64(got) - w.numpy())
    assert (err <= bound).all(), (err.max(), (err > bound).sum())


# -------------------------------------------------------------- kernels ----
@pytest.mark.parametrize("f", [7, 128, 130])
def test_bsr_plain_matches_pallas_at_bf16(f):
    """The reference's bsr_spmm is ``preferred_element_type=float32``:
    float32 products of the bfloat16 tiles and B."""
    tiles, tcol, b = bsr_inputs(0, f=f)
    (pt, jt), (pb, jb) = both(tiles, "bf16"), both(b, "bf16")
    want = jax_bsr(jt, jnp.asarray(tcol), jb, interpret=True)
    got = bsr_spmm(pt, torch.from_numpy(tcol), pb, device="cpu")
    assert got.dtype == F32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("vals_t,b_t", [("f32", "bf16"), ("bf16", "bf16"),
                                        ("bf16", "f32")])
@pytest.mark.parametrize("f", [7, 128])
def test_ell_plain_matches_pallas_at_bf16(vals_t, b_t, f):
    """Both ELL kernels upcast vals and B before they multiply: float32
    products and sums of the bfloat16 values."""
    cols, vals, tcol, unit_k, b = ell_inputs(1, f=f)
    (pv, jv), (pb, jb) = both(vals, vals_t), both(b, b_t)
    pc, pk, pu = (torch.from_numpy(np.ascontiguousarray(x))
                  for x in (cols, tcol, unit_k))
    want = jax_ragged(jnp.asarray(cols), jv, jnp.asarray(tcol),
                      jnp.asarray(unit_k), jb, interpret=True)
    got = ragged_ell_spmm(pc, pv, pk, pu, pb, device="cpu")
    assert got.dtype == F32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    want = jax_ell(jnp.asarray(cols[..., :3]), jv[..., :3],
                   jnp.asarray(tcol), jb, interpret=True)
    got = ell_spmm(pc[..., :3], pv[..., :3], pk, pb, device="cpu")
    assert got.dtype == F32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (128, 128, 128),
                                   (256, 512, 128), (100, 70, 30),
                                   (257, 129, 65), (1, 128, 128)])
def test_tile_matmul_plain_matches_pallas_at_bf16(m, k, n):
    """The reference's shapes and types (``tests/test_kernels.py:25``):
    bfloat16 A and B, a float32 accumulator, C in bfloat16."""
    rng = np.random.default_rng(m * k + n)
    (pa, ja) = both(rng.standard_normal((m, k)).astype(np.float32), "bf16")
    (pb, jb) = both(rng.standard_normal((k, n)).astype(np.float32), "bf16")
    want = jax_matmul(ja, jb, bm=128, bn=128, bk=128, interpret=True)
    got = tile_matmul(pa, pb, device="cpu")
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_bf16_close(got, want, np.abs(as_f64(pa)) @ np.abs(as_f64(pb)))


# -------------------------------------------------- the tri-engine SpMM ----
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_hybrid_spmm_bf16_matches_reference(case, backend):
    a, part, meta, ref_part, ref_meta = _edge(case)
    b = np.random.default_rng(0).standard_normal(
        (a.shape[1], 8)).astype(np.float32)
    pb, jb = both(b, "bf16")
    mag = np.abs(a.astype(np.float64)) @ np.abs(as_f64(pb))
    outs = []
    for d in DISPATCHES:
        want = rc.hybrid_spmm(ref_part, jb, meta=ref_meta, backend="xla",
                              ell_dispatch=d)
        got = tc.hybrid_spmm(part, pb, meta=meta, backend=backend,
                             ell_dispatch=d, device="cpu")
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        assert got.shape == want.shape
        assert_bf16_close(got, want, mag)
        outs.append(got)
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.parametrize("case", ["mixed_k", "no_ell_dense", "ell_overflow"])
def test_hybrid_spmm_f32_is_unchanged_by_the_bf16_path(case):
    """A float32 B runs in float32 throughout: the result is float32 and
    within the reference's float32 tolerance."""
    a, part, meta, ref_part, ref_meta = _edge(case)
    b = np.random.default_rng(1).standard_normal(
        (a.shape[1], 8)).astype(np.float32)
    want = rc.hybrid_spmm(ref_part, jnp.asarray(b), meta=ref_meta,
                          backend="xla")
    for backend in ("torch", "cuda"):
        got = tc.hybrid_spmm(part, b, meta=meta, backend=backend,
                             device="cpu")
        assert got.dtype == F32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _weights(rng, f_in, hidden, f_out):
    return ((rng.standard_normal((f_in, hidden)) * 0.3).astype(np.float32),
            (rng.standard_normal((hidden, f_out)) * 0.3).astype(np.float32))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_gcn_forward_bf16_matches_reference(case, backend):
    """The paper's 2-layer GCN with bfloat16 features and weights: X·W in
    bfloat16 (``x @ w``), each layer's aggregation at the reference's
    rounding points. The bound's |A| @ |B| is the last layer's: |A| @
    |relu(layer 1) @ W2| of the reference's own layer 1."""
    a, part, meta, ref_part, ref_meta = _edge(case)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((a.shape[1], 12)).astype(np.float32)
    w1, w2 = _weights(rng, 12, 16, 5)
    (px, jx), (p1, j1), (p2, j2) = (both(v, "bf16") for v in (x, w1, w2))
    h1 = rc.gcn_layer(ref_part, jx, j1, meta=ref_meta, backend="xla",
                      activation=lambda v: jnp.maximum(v, 0))
    mag = np.abs(a.astype(np.float64)) @ np.abs(as_f64(h1 @ j2))
    outs = []
    for d in DISPATCHES:
        want = rc.gcn_forward(ref_part, jx, [j1, j2], meta=ref_meta,
                              backend="xla", ell_dispatch=d)
        got = tc.gcn_forward(part, px, [p1, p2], meta=meta, backend=backend,
                             ell_dispatch=d, device="cpu")
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        assert got.shape == want.shape
        assert_bf16_close(got, want, mag)
        outs.append(got)
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.parametrize("x_t,w_t", [("bf16", "f32"), ("f32", "bf16")])
def test_gcn_layer_promotes_as_the_reference(x_t, w_t):
    """``x @ w`` of a bfloat16 and a float32 operand is float32 in the
    reference; so is the port's layer, within the float32 tolerance."""
    a, part, meta, ref_part, ref_meta = _edge("mixed_k")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((a.shape[1], 12)).astype(np.float32)
    w = (rng.standard_normal((12, 6)) * 0.3).astype(np.float32)
    (px, jx), (pw, jw) = both(x, x_t), both(w, w_t)
    want = rc.gcn_layer(ref_part, jx, jw, meta=ref_meta, backend="xla")
    got = tc.gcn_layer(part, px, pw, meta=meta, backend="torch",
                       device="cpu")
    assert got.dtype == F32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("entry", ["hybrid_spmm", "gcn_forward"])
def test_bf16_gradient_is_refused(entry):
    """The gradient through the hybrid SpMM is float32 only (training runs
    in float32): a bfloat16 operand that needs one raises, naming float32,
    where no gradient is recorded it runs, and a float32 one still
    differentiates."""
    a, part, meta, _, _ = _edge("mixed_k")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((a.shape[1], 12)).astype(np.float32)
    w1, w2 = _weights(rng, 12, 16, 5)

    def run(dtype):
        px = torch.from_numpy(x).to(dtype).requires_grad_()
        if entry == "hybrid_spmm":
            return px, tc.hybrid_spmm(part, px, meta=meta, backend="cuda",
                                      device="cpu")
        ws = [torch.from_numpy(w).to(dtype) for w in (w1, w2)]
        return px, tc.gcn_forward(part, px, ws, meta=meta, backend="cuda",
                                  device="cpu")

    with pytest.raises(NotImplementedError, match="float32"):
        run(BF16)
    with torch.no_grad():
        assert run(BF16)[1].dtype == BF16
    px, y = run(F32)
    y.sum().backward()
    assert px.grad.dtype == F32 and torch.isfinite(px.grad).all()
