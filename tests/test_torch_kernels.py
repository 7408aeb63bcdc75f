"""The port's kernels and their plain versions against the JAX kernels.

On the CPU the kernel wrappers run their plain PyTorch versions; these
are held against the Pallas kernels run as the JAX tests run them
(``interpret=True``), on small seeded numpy inputs. Tolerance: float32
``rtol=1e-5, atol=1e-6`` — the products are the same but the two
frameworks may add them in another order (and may or may not fuse the
multiply-add). A leading group axis must give, bit for bit, what a loop
over the members gives.

Tests marked ``cuda`` build and launch the CUDA kernels; they skip
without a card (run them with ``python -m pytest -m cuda
tests/test_torch_kernels.py`` on a machine with an H100). JAX is
imported only by the tests that use it, so that those run where JAX is
not installed. On the card: the ELL kernels equal their plain versions
bit for bit (multiply and add rounded separately in both);
``tile_matmul`` is within ``|C - C_ref| <= 1e-6 + 1e-5 * (|A| @ |B|)``
of cuBLAS (float32 sums of K terms in two orders) and gives the same
bits for every block shape.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spmm import bsr_spmm
from repro_torch.kernels.ell_spmm import ell_spmm, ragged_ell_spmm
from repro_torch.kernels.ref import (bsr_spmm_ref, ell_spmm_ref,
                                     ragged_ell_spmm_ref, tile_matmul_ref)
from repro_torch.kernels.tile_matmul import CONFIGS, tile_matmul

from conftest import make_heterogeneous_matrix

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def bsr_inputs(seed, n_t=5, t=16, nct=3, f=7, g=None):
    rng = np.random.default_rng(seed)
    lead = () if g is None else (g,)
    tiles = (rng.standard_normal(lead + (n_t, t, t))
             * (rng.random(lead + (n_t, t, t)) < 0.6)).astype(np.float32)
    tcol = rng.integers(0, nct, lead + (n_t,)).astype(np.int32)
    b = rng.standard_normal(lead + (nct, t, f)).astype(np.float32)
    return tiles, tcol, b


def ell_inputs(seed, u=9, r=8, kmax=5, t=16, nct=3, f=7, g=None):
    rng = np.random.default_rng(seed)
    lead = () if g is None else (g,)
    unit_k = np.sort(rng.integers(1, kmax + 1, lead + (u,)))[..., ::-1]
    unit_k = np.ascontiguousarray(unit_k).astype(np.int32)
    unit_k[..., -1] = 0                            # a dead unit
    live = np.arange(kmax) < unit_k[..., None, None]
    cols = (rng.integers(0, t, lead + (u, r, kmax)) * live).astype(np.int32)
    vals = (rng.standard_normal(lead + (u, r, kmax)) * live).astype(
        np.float32)
    tcol = rng.integers(0, nct, lead + (u,)).astype(np.int32)
    b = rng.standard_normal(lead + (nct, t, f)).astype(np.float32)
    return cols, vals, tcol, unit_k, b


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("f", [7, 128, 130])
def test_bsr_plain_matches_pallas(f):
    import jax.numpy as jnp
    from repro.kernels.bsr_spmm import bsr_spmm as jax_bsr
    tiles, tcol, b = bsr_inputs(0, f=f)
    want = np.asarray(jax_bsr(jnp.asarray(tiles), jnp.asarray(tcol),
                              jnp.asarray(b), interpret=True))
    got = bsr_spmm(*_t(tiles, tcol, b), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert got.shape == (5, 16, f)


@pytest.mark.parametrize("f", [7, 128, 130])
def test_ragged_ell_plain_matches_pallas(f):
    import jax.numpy as jnp
    from repro.kernels.ell_spmm import ragged_ell_spmm as jax_ragged
    cols, vals, tcol, unit_k, b = ell_inputs(1, f=f)
    runs = []
    for k in unit_k:
        if runs and runs[-1][0] == int(k):
            runs[-1][1] += 1
        else:
            runs.append([int(k), 1])
    for segments in ((), tuple(map(tuple, runs))):
        want = np.asarray(jax_ragged(
            jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(tcol),
            jnp.asarray(unit_k), jnp.asarray(b), segments=segments,
            interpret=True))
        got = ragged_ell_spmm(*_t(cols, vals, tcol, unit_k, b), device="cpu")
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the dead unit (unit_k == 0) writes zeros
    assert unit_k[-1] == 0
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))


def test_ragged_ell_mask_on_values_propagates_nonfinite_b():
    """As in the reference oracle, a masked lane multiplies 0 by its B
    row, so a non-finite B row reaches the output through masked lanes
    too — the kernel must loop to Kmax, not stop at unit_k."""
    import jax.numpy as jnp
    from repro.kernels.ref import ragged_ell_spmm_ref as jax_ref
    cols, vals, tcol, unit_k, b = ell_inputs(2)
    b[tcol[0], 0, 0] = np.inf     # padded lanes read col 0 of their tile
    want = np.asarray(jax_ref(*map(jnp.asarray,
                                   (cols, vals, tcol, unit_k, b))))
    got = ragged_ell_spmm_ref(*_t(cols, vals, tcol, unit_k, b)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any()


@pytest.mark.parametrize("kernel", ["bsr", "ell"])
def test_group_axis_bitwise_equals_member_loop(kernel):
    g = 3
    if kernel == "bsr":
        args = _t(*bsr_inputs(3, g=g))
        run = lambda *a: bsr_spmm(*a, device="cpu")   # noqa: E731
    else:
        args = _t(*ell_inputs(4, g=g))
        run = lambda *a: ragged_ell_spmm(*a, device="cpu")  # noqa: E731
    grouped = run(*args)
    for i in range(g):
        assert torch.equal(grouped[i], run(*(a[i] for a in args)))


def test_wrappers_check_inputs():
    tiles, tcol, b = _t(*bsr_inputs(0))
    with pytest.raises(ValueError):
        bsr_spmm(tiles, tcol.long(), b, device="cpu")
    with pytest.raises(ValueError):
        bsr_spmm(tiles[:, :8], tcol, b, device="cpu")
    cols, vals, tc, uk, bb = _t(*ell_inputs(0))
    with pytest.raises(ValueError):
        ragged_ell_spmm(cols, vals.double(), tc, uk, bb, device="cpu")
    with pytest.raises(ValueError):
        ragged_ell_spmm(cols, vals, tc[:-1], uk, bb, device="cpu")


def test_cpu_tensors_never_count_launches():
    ops.reset_launch_counts()
    bsr_spmm(*_t(*bsr_inputs(0)), device="cpu")
    ragged_ell_spmm(*_t(*ell_inputs(0)), device="cpu")
    assert ops.launch_counts() == {"bsr_spmm": 0, "ragged_ell_spmm": 0,
                                   "ell_spmm": 0, "tile_matmul": 0,
                                   "coo_rows": 0}


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bsr_spmm(*_t(*bsr_inputs(0)))
    with pytest.raises(RuntimeError, match="CUDA"):
        ragged_ell_spmm(*_t(*ell_inputs(0)))


def test_ell_dispatch_other_than_ragged_raises():
    """Only the three dispatches of the reference exist: an unknown one
    raises (reference ``test_ragged_ell.py`` test_unknown_dispatch_raises);
    "fused" and "loop" run (tests/test_torch_dispatch.py)."""
    from repro_torch.core.formats import PartitionMeta
    meta = PartitionMeta(64, 64, 64, (), 1, 1, 0, 0, 0, 0, 0, (0.5, 0.01))
    with pytest.raises(ValueError, match="unknown ell dispatch"):
        ops.ell_matmul(None, torch.zeros(1, 64, 4), meta, None, None,
                       dispatch="bogus")


# ---------------------------------------------------------- on the card ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("f,g", [(7, None), (128, None), (130, 4)])
def test_cuda_kernels_match_plain(cuda_device, f, g):
    ops.reset_launch_counts()
    bargs = [a.to(cuda_device) for a in _t(*bsr_inputs(5, t=64, f=f, g=g))]
    got = bsr_spmm(*bargs)
    torch.testing.assert_close(got, bsr_spmm_ref(*bargs), **TOL)
    eargs = [a.to(cuda_device) for a in _t(*ell_inputs(6, t=64, f=f, g=g))]
    got = ragged_ell_spmm(*eargs)
    # multiply and add rounded separately in both: bit-identical
    assert torch.equal(got, ragged_ell_spmm_ref(*eargs))
    assert ops.launch_counts() == {"bsr_spmm": 1, "ragged_ell_spmm": 1,
                                   "ell_spmm": 0, "tile_matmul": 0,
                                   "coo_rows": 0}


@pytest.mark.cuda
def test_cuda_kernel_rejects_non_contiguous(cuda_device):
    tiles, tcol, b = (a.to(cuda_device) for a in _t(*bsr_inputs(0, t=64)))
    with pytest.raises(ValueError, match="contiguous"):
        bsr_spmm(tiles.transpose(1, 2), tcol, b)


@pytest.mark.cuda
@pytest.mark.parametrize("f,g", [(7, None), (128, None), (130, 4)])
def test_cuda_ell_spmm_matches_plain_bitwise(cuda_device, f, g):
    ops.reset_launch_counts()
    cols, vals, tcol, _, b = (a.to(cuda_device) for a in _t(*ell_inputs(
        7, t=64, f=f, g=g, kmax=9)))
    got = ell_spmm(cols[..., :5], vals[..., :5], tcol, b)   # strided view
    assert torch.equal(got, ell_spmm_ref(cols[..., :5], vals[..., :5], tcol,
                                         b))
    out = torch.full((got.shape[:-3] + (11,) + got.shape[-2:]), 7.0,
                     device=cuda_device)
    ell_spmm(cols[..., :5], vals[..., :5], tcol, b,
             out=out[..., 1:10, :, :])
    assert torch.equal(out[..., 1:10, :, :], got)
    assert bool((out[..., 0, :, :] == 7.0).all())
    assert ops.launch_counts()["ell_spmm"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(70, 33, 5), (257, 300, 130),
                                   (3328, 1433, 128), (4096, 3703, 128)])
def test_cuda_tile_matmul_matches_plain(cuda_device, m, k, n):
    ops.reset_launch_counts()
    rng = np.random.default_rng(m)
    a, b = (x.to(cuda_device) for x in _t(
        rng.standard_normal((m, k)).astype(np.float32),
        rng.standard_normal((k, n)).astype(np.float32)))
    outs = [tile_matmul(a, b, config=c) for c in CONFIGS]
    # one FMA chain per element in ascending k: every configuration agrees
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert torch.equal(tile_matmul(a, b), outs[0])
    bound = 1e-6 + 1e-5 * tile_matmul_ref(a.abs(), b.abs())
    assert bool(((outs[0] - tile_matmul_ref(a, b)).abs() <= bound).all())
    assert ops.launch_counts()["tile_matmul"] == len(CONFIGS) + 1


@pytest.mark.cuda
def test_cuda_fused_and_loop_launch_once_per_band(cuda_device):
    import repro_torch.core as tc
    a = make_heterogeneous_matrix(300, seed=0)
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    assert len(meta.ell_segments) > 1
    b = np.random.default_rng(0).standard_normal((300, 16)).astype(
        np.float32)
    ragged = tc.hybrid_spmm(part, b, meta=meta)
    for d in ("fused", "loop"):
        ops.reset_launch_counts()
        y = tc.hybrid_spmm(part, b, meta=meta, ell_dispatch=d)
        torch.cuda.synchronize()
        # one fixed-K launch for all the buckets, one COO row launch
        assert ops.launch_counts() == {
            "bsr_spmm": 1, "ragged_ell_spmm": 0, "ell_spmm": 1,
            "tile_matmul": 0, "coo_rows": int(meta.nnz_coo > 0)}
        assert torch.equal(y, ragged)
