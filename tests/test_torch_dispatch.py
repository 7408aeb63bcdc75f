"""The per-K ELL dispatches and the tiled matmul of the port against the
JAX reference.

Covers ``ell_buckets`` (exact round trip against the reference), the
plain versions of the fixed-K ``ell_spmm`` and of ``tile_matmul``
against the Pallas kernels in interpret mode, ``hybrid_spmm`` with the
three ELL dispatches on both backends against the reference's
``hybrid_spmm(backend="xla")`` on the reference's edge-case graphs, and
the port's own bitwise contracts.

Tolerances: ELL kernels ``rtol=1e-5, atol=1e-6`` (the same float32
products, another summation order, and XLA may fuse the multiply-add);
``tile_matmul`` ``|C - C_ref| <= 1e-6 + 1e-5 * (|A| @ |B|)``, a multiple
of the float32 rounding of K-term sums taken in two orders (a plain
``rtol`` fails where terms cancel); SpMM
outputs ``rtol=1e-5, atol=1e-5`` (three engines' partial sums added in
another order than XLA's). Within the port the dispatches are held bit
for bit: "fused" equals "ragged" on finite B, and "loop", which adds
bucket after bucket into one running buffer in unit order (as the
reference's sequential "loop" scatter does), equals "fused" as well.

The CUDA kernels' own tests are in ``tests/test_torch_kernels.py``
(marked ``cuda``), which imports no JAX at module level, so that they run
on a machine with a card and without JAX.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as rc
import repro_torch.core as tc
from repro.kernels.ell_spmm import ell_spmm as jax_ell_spmm
from repro.kernels.tile_matmul import tile_matmul as jax_tile_matmul
from repro_torch.core.formats import (RaggedEll, ell_buckets, plan_to,
                                      reduction_plan,
                                      scatter_ell_partials)
from repro_torch.kernels import ops
from repro_torch.kernels.ell_spmm import ell_spmm, ragged_ell_spmm
from repro_torch.kernels.ref import (ell_spmm_ref, ragged_ell_spmm_ref,
                                     tile_matmul_ref)
from repro_torch.kernels.tile_matmul import BLOCK_NS, tile_matmul

from conftest import (OVERFLOW_CFG, make_heterogeneous_matrix,
                      make_overflow_matrix)

torch.set_num_threads(2)

KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
MATMUL_TOL = dict(atol=1e-6, rtol=1e-5)    # rtol scales |A| @ |B|
SPMM_TOL = dict(rtol=1e-5, atol=1e-5)
DISPATCHES = ("ragged", "fused", "loop")


def _single_k_matrix(n=192):
    """The reference's single-K fixture (tests/test_ragged_ell.py)."""
    a = np.zeros((n, n), np.float32)
    rng = np.random.default_rng(1)
    for j in range(64):
        t = (j * 3) // 64
        a[j, 64 * t + rng.choice(64, 3, replace=False)] = \
            rng.standard_normal(3)
    return a


# The reference's EDGE_CASES (tests/test_ragged_ell.py), as config dicts.
EDGE_CASES = {
    "no_ell_empty": (lambda: np.zeros((100, 100), np.float32),
                     dict(tile=64)),
    "no_ell_dense": (lambda: np.abs(np.random.default_rng(2)
                                    .standard_normal((64, 64))
                                    ).astype(np.float32), dict(tile=64)),
    "single_k": (_single_k_matrix, dict(tile=64)),
    "mixed_k": (lambda: make_heterogeneous_matrix(300, seed=0),
                dict(tile=64)),
    "ell_overflow": (make_overflow_matrix, OVERFLOW_CFG),
}


def _edge(name):
    build, cfg = EDGE_CASES[name]
    a = build()
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(**cfg))
    ref_part, ref_meta, _ = rc.analyze_and_partition(
        rc.csr_from_dense(a), rc.PartitionConfig(**cfg))
    return a, part, meta, ref_part, ref_meta


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def bucket_inputs(seed, u=6, r=8, k=5, t=16, nct=3, f=7, g=None):
    rng = np.random.default_rng(seed)
    lead = () if g is None else (g,)
    cols = rng.integers(0, t, lead + (u, r, k)).astype(np.int32)
    vals = rng.standard_normal(lead + (u, r, k)).astype(np.float32)
    tcol = rng.integers(0, nct, lead + (u,)).astype(np.int32)
    b = rng.standard_normal(lead + (nct, t, f)).astype(np.float32)
    return cols, vals, tcol, b


def matmul_close(got, want, a, b) -> bool:
    bound = (MATMUL_TOL["atol"]
             + MATMUL_TOL["rtol"] * tile_matmul_ref(a.abs(), b.abs()))
    return bool(((got - want).abs() <= bound).all())


# ---------------------------------------------------------- ell_buckets ----
def test_bucket_round_trip_matches_reference_exactly():
    _, part, meta, ref_part, ref_meta = _edge("mixed_k")
    assert meta.ell_segments == ref_meta.ell_segments
    assert len(meta.ell_segments) > 1, "fixture must mix K widths"
    got = ell_buckets(part.ell, meta.ell_segments)
    want = rc.ell_buckets(ref_part.ell, ref_meta.ell_segments)
    assert len(got) == len(want) == len(meta.ell_segments)
    unit_k = np.asarray(part.ell.unit_k)
    at = 0
    for bg, bw, (k, n) in zip(got, want, meta.ell_segments):
        for field in ("cols", "vals", "rows", "tile_col"):
            a, b = np.asarray(getattr(bg, field)), np.asarray(getattr(bw,
                                                                      field))
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b)
        assert bg.cols.shape == (n, part.ell.r_block, k)
        np.testing.assert_array_equal(unit_k[at:at + n], k)
        np.testing.assert_array_equal(np.asarray(part.ell.vals)[at:at + n,
                                                                :, k:], 0.0)
        at += n
    assert at == part.ell.n_units
    # without segments: one Kmax-wide bucket, as in the reference
    (whole,) = ell_buckets(part.ell)
    (ref_whole,) = rc.ell_buckets(ref_part.ell)
    np.testing.assert_array_equal(whole.cols, np.asarray(ref_whole.cols))


def test_bucket_group_axis_and_coverage():
    _, part, meta, _, _ = _edge("mixed_k")
    placed = tc.partition_to(part, "cpu")
    stacked = RaggedEll(*(torch.stack([a, a]) for a in placed.ell))
    for bs, b1 in zip(ell_buckets(stacked, meta.ell_segments),
                      ell_buckets(placed.ell, meta.ell_segments)):
        for x, y in zip(bs, b1):
            assert torch.equal(x[0], y) and torch.equal(x[1], y)
        # buckets are views of the ragged slab, not copies
        assert bs.cols.data_ptr() >= stacked.cols.data_ptr()
    with pytest.raises(ValueError, match="do not cover"):
        ell_buckets(placed.ell, ((4, 1),))
    assert ell_buckets(tc.partition_to(_edge("no_ell_empty")[1],
                                       "cpu").ell, ()) == ()


# --------------------------------------------------------- plain kernels ----
@pytest.mark.parametrize("u,r,k,t,nct,f", [
    (1, 8, 1, 64, 1, 32), (6, 8, 5, 16, 3, 7), (4, 8, 17, 64, 2, 130),
    (3, 4, 3, 16, 2, 128)])
def test_ell_spmm_plain_matches_pallas(u, r, k, t, nct, f):
    cols, vals, tcol, b = bucket_inputs(u * 7 + k, u=u, r=r, k=k, t=t,
                                        nct=nct, f=f)
    want = np.asarray(jax_ell_spmm(jnp.asarray(cols), jnp.asarray(vals),
                                   jnp.asarray(tcol), jnp.asarray(b),
                                   interpret=True))
    got = ell_spmm(*_t(cols, vals, tcol, b), device="cpu")
    assert got.shape == (u, r, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    assert torch.equal(got, ell_spmm_ref(*_t(cols, vals, tcol, b)))


def test_ell_spmm_equals_ragged_on_live_lanes_bitwise():
    """A unit of a K-wide bucket whose unit_k <= K: the fixed-K chain and
    the masked Kmax chain agree bit for bit on finite B."""
    cols, vals, tcol, b = bucket_inputs(3, k=6)
    rng = np.random.default_rng(3)
    unit_k = rng.integers(0, 7, 6).astype(np.int32)
    live = np.arange(6) < unit_k[:, None, None]
    cols, vals = cols * live, (vals * live).astype(np.float32)
    wide = [np.concatenate([x, np.zeros_like(x)], axis=-1)
            for x in (cols, vals)]          # the ragged slab, Kmax = 12
    got = ell_spmm(*_t(cols, vals, tcol, b), device="cpu")
    want = ragged_ell_spmm(*_t(wide[0], wide[1], tcol, unit_k, b),
                           device="cpu")
    assert torch.equal(got, want)


def test_ell_spmm_group_axis_bitwise_and_views():
    g = 3
    cols, vals, tcol, b = _t(*bucket_inputs(4, g=g, k=7))
    grouped = ell_spmm(cols, vals, tcol, b, device="cpu")
    for i in range(g):
        assert torch.equal(grouped[i], ell_spmm(cols[i], vals[i], tcol[i],
                                                b[i], device="cpu"))
    # a strided K view and an out= slice give what contiguous copies give
    view = ell_spmm(cols[..., :4], vals[..., :4], tcol, b, device="cpu")
    assert torch.equal(view, ell_spmm(cols[..., :4].contiguous(),
                                      vals[..., :4].contiguous(), tcol, b,
                                      device="cpu"))
    buf = torch.full((g, 10, 8, b.shape[-1]), 7.0)
    ell_spmm(cols, vals, tcol, b, out=buf[:, 2:8], device="cpu")
    assert torch.equal(buf[:, 2:8], grouped)
    assert bool((buf[:, :2] == 7.0).all() and (buf[:, 8:] == 7.0).all())


def test_ell_spmm_checks_inputs():
    cols, vals, tcol, b = _t(*bucket_inputs(0))
    with pytest.raises(ValueError):
        ell_spmm(cols, vals.double(), tcol, b, device="cpu")
    with pytest.raises(ValueError):
        ell_spmm(cols, vals, tcol[:-1], b, device="cpu")
    with pytest.raises(ValueError):
        ell_spmm(cols, vals, tcol, b, out=torch.empty(1), device="cpu")


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (70, 33, 5), (257, 300, 130),
                                   (64, 128, 128), (19, 0, 4)])
def test_tile_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = tile_matmul(*_t(a, b), device="cpu")
    assert got.shape == (m, n) and got.dtype == torch.float32
    if k:
        want = np.asarray(jax_tile_matmul(jnp.asarray(a), jnp.asarray(b),
                                          interpret=True))
        assert matmul_close(got, torch.from_numpy(want), *_t(a, b))
    else:
        assert torch.equal(got, torch.zeros(m, n))
    assert torch.equal(ops.matmul(*_t(a, b)), got)
    assert torch.equal(tile_matmul_ref(*_t(a, b)), got)


def test_tile_matmul_knobs_and_checks():
    a, b = _t(np.ones((5, 3), np.float32), np.ones((3, 2), np.float32))
    for bn in BLOCK_NS:
        assert torch.equal(ops.matmul(a, b, bn=bn), torch.full((5, 2), 3.0))
    with pytest.raises(ValueError, match="block width"):
        tile_matmul(a, b, bn=256, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        tile_matmul(a, a, device="cpu")
    assert tile_matmul(a.double(), b.double(), device="cpu").dtype == \
        torch.float64


# ----------------------------------------------------- dispatch parity -----
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_all_dispatches_match_reference(name, backend):
    a, part, meta, ref_part, ref_meta = _edge(name)
    b = np.random.default_rng(0).standard_normal((a.shape[1], 16)).astype(
        np.float32)
    ys = {}
    for d in DISPATCHES:
        ys[d] = tc.hybrid_spmm(part, b, meta=meta, backend=backend,
                               ell_dispatch=d, device="cpu")
        want = np.asarray(rc.hybrid_spmm(ref_part, jnp.asarray(b),
                                         meta=ref_meta, backend="xla",
                                         ell_dispatch=d))
        np.testing.assert_allclose(ys[d].numpy(), want, **SPMM_TOL)
        np.testing.assert_allclose(ys[d].numpy(), a @ b, rtol=2e-5,
                                   atol=2e-4)
    # within the port: fused == ragged bitwise (the reference's
    # acceptance test), and loop == fused bitwise (same addition order)
    assert torch.equal(ys["fused"], ys["ragged"])
    assert torch.equal(ys["loop"], ys["fused"])


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_nonfinite_b_matches_the_references_own_dispatch(dispatch):
    """With inf/NaN in B the dispatches differ (ragged multiplies masked
    lanes by 0, fused/loop never read them), in the reference too: each
    is held against the reference's own dispatch."""
    a, part, meta, ref_part, ref_meta = _edge("mixed_k")
    b = np.random.default_rng(1).standard_normal((a.shape[1], 8)).astype(
        np.float32)
    b[0, :3] = (np.inf, -np.inf, np.nan)   # padded lanes read col 0
    b[70, 4] = np.inf
    got = tc.hybrid_spmm(part, b, meta=meta, backend="cuda",
                         ell_dispatch=dispatch, device="cpu").numpy()
    want = np.asarray(rc.hybrid_spmm(ref_part, jnp.asarray(b), meta=ref_meta,
                                     backend="xla", ell_dispatch=dispatch))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **SPMM_TOL)
    assert not fin.all()


def test_dispatches_on_a_stacked_group_bitwise():
    """A stacked group runs the bucket kernels once for all members and
    each member gets exactly its own result."""
    from repro_torch.core.formats import TriPartition
    from repro_torch.engine.shape_class import ClassRegistry, pad_to_class
    reg = ClassRegistry()
    padded = []
    for i in range(2):
        a = make_heterogeneous_matrix(300 + 4 * i, seed=i)
        part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                                 tc.PartitionConfig(tile=64))
        padded.append(pad_to_class(part, meta, reg.classify(part, meta)))
    meta = padded[0][1]
    assert len(meta.ell_segments) > 1
    stack = TriPartition(*(type(c)(*(np.stack(leaves)
                                     for leaves in zip(*comps)))
                           for c, comps in zip(padded[0][0],
                                               zip(*[p for p, _ in padded]))))
    b = np.random.default_rng(5).standard_normal(
        (2, meta.n_cols, 6)).astype(np.float32)
    assert reduction_plan(stack, meta).ell_buckets == ()
    plan = reduction_plan(stack, meta, loop=True)
    assert len(plan.ell_buckets) == len(meta.ell_segments)
    ragged = tc.hybrid_spmm(stack, b, meta=meta, device="cpu")
    for d in ("fused", "loop"):
        y = tc.hybrid_spmm(stack, b, meta=meta, ell_dispatch=d, plan=plan,
                           device="cpu")
        assert torch.equal(y, ragged)
        for i, (p, m) in enumerate(padded):
            assert torch.equal(y[i], tc.hybrid_spmm(
                p, b[i], meta=m, ell_dispatch=d, device="cpu"))


def test_loop_scatter_list_form_matches_one_reduction():
    """``scatter_ell_partials`` over aligned bucket lists (the "loop"
    dispatch), with and without prebuilt plans, equals one reduction
    over the concatenation bit for bit."""
    _, part, meta, _, _ = _edge("mixed_k")
    placed = tc.partition_to(part, "cpu")
    rng = np.random.default_rng(2)
    u, r = placed.ell.rows.shape
    prod = torch.from_numpy(rng.standard_normal((u, r, 5)).astype(
        np.float32))
    once = scatter_ell_partials(placed.ell.rows.reshape(-1),
                                prod.reshape(-1, 5), meta)
    rows, partials, at = [], [], 0
    for bucket in ell_buckets(placed.ell, meta.ell_segments):
        n = bucket.rows.shape[0]
        rows.append(bucket.rows.reshape(-1))
        partials.append(prod[at:at + n].reshape(-1, 5))
        at += n
    assert torch.equal(scatter_ell_partials(rows, partials, meta), once)
    plans = plan_to(reduction_plan(placed, meta, loop=True),
                    "cpu").ell_buckets
    assert torch.equal(scatter_ell_partials(rows, partials, meta,
                                            plan=plans), once)
