"""The sparse engine with its sum onto rows and the add onto the dense
engine's rows folded in (``ragged_ell_rows``).

``ragged_ell_rows`` is the "ragged" ELL dispatch as the port's main path
runs it: the per-unit products, summed onto padded output rows in the
order of the ELL ``SegmentPlan``, then added onto the dense engine's rows
in place. On the CPU it runs its plain version ``ragged_ell_rows_ref``
(``ragged_ell_spmm_ref``, ``segment_sum``, the add). That is held bit for
bit against the parent's chain (``ragged_ell_spmm_ref``,
``scatter_ell_partials``, ``yd + ye``), and the whole SpMM and GCN against
the JAX reference (``hybrid_spmm(backend="xla")`` and the Pallas kernels in
interpret mode) within ``rtol=1e-4, atol=1e-5``: the same float32
products, added in another order by another framework.

The kernel leaves rows without an ELL entry untouched, which equals
``yd + 0`` only because the dense engine never writes -0: that premise is
tested here too, on graphs with negative weights.

Tests marked ``cuda`` launch the kernel (also past 4 K bands, where it
reads each unit's band K from the kept table); they skip without a card.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.formats import (PartitionMeta, ReductionPlan,
                                      b_tiles_of, plan_to, reduction_plan,
                                      scatter_ell_partials, segment_live,
                                      segment_plan, segment_sum, stack_plans)
from repro_torch.data.graphs import make_paper_dataset
from repro_torch.engine.shape_class import ClassRegistry, pad_to_class
from repro_torch.kernels import ops
from repro_torch.kernels.ell_spmm import ragged_ell_rows, ragged_ell_spmm
from repro_torch.kernels.ref import (bsr_spmm_rows_ref, ragged_ell_rows_ref,
                                     ragged_ell_spmm_ref)

from conftest import make_heterogeneous_matrix

torch.set_num_threads(2)

SPMM_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def assert_same_bits(a, b):
    """Bitwise equal (the sign of zero included), NaN payloads aside."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _meta(t, n_row_tiles, n_col_tiles):
    return PartitionMeta(n_row_tiles * t, n_col_tiles * t, t, (),
                         n_row_tiles, n_col_tiles, 0, 0, 0, 0, 0,
                         (0.5, 0.01))


# Each case: (G, rows drawn from, fraction of sentinel rows, non-finite B
# on a masked lane). Rows are drawn from a few of the P padded rows, so
# several units share a row and most rows have no entry.
CASES = {
    "g1": (1, 48, 0.0, False),
    "g3": (3, 48, 0.0, False),
    "sentinel_rows": (2, 48, 0.4, False),
    "rows_without_entries": (2, 6, 0.1, False),
    "units_share_rows": (3, 3, 0.0, False),
    "nonfinite_b_masked_lane": (2, 48, 0.2, True),
}


def ell_rows_inputs(case, seed=0, u=10, r=8, kmax=6, t=16, nct=3, nrt=3,
                    f=7):
    """Ragged ELL leaves [G, ...], B tiles, the stacked ELL plan, the
    dense rows ``yd`` [G, P, F] and the meta of one case."""
    g, n_rows, sentinel_frac, nonfinite = CASES[case]
    rng = np.random.default_rng(seed)
    meta = _meta(t, nrt, nct)
    p = meta.n_padded_rows
    unit_k = np.sort(rng.integers(0, kmax + 1, (g, u)), axis=1)[:, ::-1]
    unit_k = np.ascontiguousarray(unit_k).astype(np.int32)
    live = np.arange(kmax) < unit_k[:, :, None, None]
    cols = (rng.integers(0, t, (g, u, r, kmax)) * live).astype(np.int32)
    vals = (rng.standard_normal((g, u, r, kmax)) * live).astype(np.float32)
    tcol = rng.integers(0, nct, (g, u)).astype(np.int32)
    pick = rng.choice(p, n_rows, replace=False)
    rows = pick[rng.integers(0, n_rows, (g, u, r))].astype(np.int32)
    rows[rng.random((g, u, r)) < sentinel_frac] = meta.ell_sentinel_row
    b = rng.standard_normal((g, nct, t, f)).astype(np.float32)
    b[..., 0, :] = np.where(rng.random((g, nct, f)) < 0.3, -0.0,
                            b[..., 0, :])
    if nonfinite:
        # padded lanes read col 0 of their tile: inf there reaches the
        # output through masked lanes only (0 * inf = NaN)
        dead = np.flatnonzero(unit_k[0] < kmax)[0]
        b[0, tcol[0, dead], 0, 0] = np.inf
    yd = rng.standard_normal((g, p, f)).astype(np.float32)
    yd[rng.random((g, p, f)) < 0.1] = 0.0
    plan = stack_plans([ReductionPlan(*[segment_plan(
        rows[i].reshape(-1), p,
        rows[i].reshape(-1) != meta.ell_sentinel_row)] * 3)
        for i in range(g)])
    return (cols, vals, tcol, unit_k, rows, b, yd), plan_to(plan, "cpu"), \
        meta


def parent_chain(cols, vals, tcol, unit_k, rows, bt, yd, plan, meta):
    """What the parent computed: per-unit products, their scatter onto
    rows (``segment_sum`` in plan order), then ``yd + ye``."""
    g, u, r, _ = cols.shape
    prod = ragged_ell_spmm_ref(cols, vals, tcol, unit_k, bt)
    ye = scatter_ell_partials(rows.reshape(g, u * r),
                              prod.reshape(g, u * r, -1), meta, plan=plan)
    return yd + ye


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_ref_equals_units_scatter_add_bitwise(case):
    (cols, vals, tcol, uk, rows, b, yd), plan, meta = ell_rows_inputs(case)
    cols, vals, tcol, uk, rows, b, yd = _t(cols, vals, tcol, uk, rows, b, yd)
    want = parent_chain(cols, vals, tcol, uk, rows, b, yd, plan.ell, meta)
    out = yd.clone()
    got = ragged_ell_rows(cols, vals, tcol, uk, b, plan.ell, out,
                          device="cpu")
    assert got is out                                  # in place
    assert_same_bits(got, want)
    assert_same_bits(got, ragged_ell_rows_ref(cols, vals, tcol, uk, b,
                                              plan.ell, yd.clone()))
    # rows without an entry keep yd's bits
    empty = (plan.ell.lengths == 0).reshape(got.shape[:2])
    assert bool(empty.any())
    assert_same_bits(got[empty], yd[empty])
    if CASES[case][3]:
        assert bool(torch.isnan(got).any())
        assert not bool(torch.isnan(yd).any())


def test_rows_shared_by_several_units_sum_in_plan_order():
    (cols, vals, tcol, uk, rows, b, yd), plan, _ = ell_rows_inputs(
        "units_share_rows")
    assert int(plan.ell.lengths.max()) > 1
    cols, vals, tcol, uk, b = _t(cols, vals, tcol, uk, b)
    g, u, r, _ = cols.shape
    prod = ragged_ell_spmm_ref(cols, vals, tcol, uk, b).reshape(g * u * r, -1)
    got = ragged_ell_rows(cols, vals, tcol, uk, b, plan.ell,
                          torch.zeros(yd.shape), device="cpu")
    order, offsets = plan.ell.order.numpy(), plan.ell.offsets.numpy()
    for s in np.flatnonzero(plan.ell.lengths.numpy()):
        acc = torch.zeros(prod.shape[1])
        for e in order[offsets[s]:offsets[s + 1]]:
            acc = acc + prod[e]
        assert torch.equal(got.reshape(-1, prod.shape[1])[s], acc)


def test_rows_wrapper_checks_inputs_and_counts_no_cpu_launch():
    (cols, vals, tcol, uk, _, b, yd), plan, _ = ell_rows_inputs("g3")
    cols, vals, tcol, uk, b, yd = _t(cols, vals, tcol, uk, b, yd)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="out"):
        ragged_ell_rows(cols, vals, tcol, uk, b, plan.ell, yd[:, :-1],
                        device="cpu")
    with pytest.raises(ValueError, match="plan"):
        ragged_ell_rows(cols[:, :-1].contiguous(), vals[:, :-1].contiguous(),
                        tcol[:, :-1].contiguous(), uk[:, :-1].contiguous(),
                        b, plan.ell, yd, device="cpu")
    ragged_ell_rows(cols, vals, tcol, uk, b, plan.ell, yd, device="cpu")
    assert ops.launch_counts()["ragged_ell_spmm"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ragged_ell_rows(cols, vals, tcol, uk, b, plan.ell, yd)


# ------------------------------------------------- the in-place premise ----
def _graph(kind):
    """A dense matrix with negative weights: the paper's three regimes,
    or a cora-like graph with its weights' signs drawn at random."""
    if kind == "hetero":
        return make_heterogeneous_matrix(300, seed=3)
    csr, _, _, _ = make_paper_dataset("cora", scale=0.2, seed=0)
    a = np.zeros(csr.shape, np.float32)
    for i in range(csr.shape[0]):
        idx = csr.indices[csr.indptr[i]:csr.indptr[i + 1]]
        a[i, idx] = csr.data[csr.indptr[i]:csr.indptr[i + 1]]
    sign = np.where(np.random.default_rng(1).random(a.shape) < 0.5, -1, 1)
    return (a * sign).astype(np.float32)


def _padded(a):
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    return pad_to_class(part, meta, ClassRegistry().classify(part, meta))


@pytest.mark.parametrize("kind", ["hetero", "cora_signed"])
@pytest.mark.parametrize("padded", [False, True])
def test_dense_engine_output_holds_no_negative_zero(kind, padded):
    a = _graph(kind)
    assert (a < 0).any()
    if padded:
        part, meta = _padded(a)
    else:
        part, meta, _ = tc.analyze_and_partition(
            tc.csr_from_dense(a), tc.PartitionConfig(tile=64))
    assert meta.n_dense_tiles > 0
    plan = plan_to(reduction_plan(part, meta), "cpu")
    rng = np.random.default_rng(2)
    b = rng.standard_normal((1, meta.n_cols, 9)).astype(np.float32)
    b[rng.random(b.shape) < 0.3] = -0.0            # products of -0 too
    b[rng.random(b.shape) < 0.1] = 0.0
    tiles, _, tcol = (torch.from_numpy(np.asarray(x))[None]
                      for x in part.dense)
    yd = bsr_spmm_rows_ref(tiles, tcol, b_tiles_of(torch.from_numpy(b),
                                                   meta), plan.dense)
    assert bool((yd == 0).any())
    assert not bool(((yd == 0) & torch.signbit(yd)).any())
    # and through the port's dense route, as the main path calls it
    ydo = ops.dense_tiles_matmul(tc.partition_to(tc.TriPartition(
        tc.DenseTiles(*(np.asarray(x)[None] for x in part.dense)),
        part.ell, part.coo), "cpu"), torch.from_numpy(b), meta, plan)
    assert not bool(((ydo == 0) & torch.signbit(ydo)).any())


# --------------------------------------------------------- live segments ----
@pytest.mark.parametrize("g", [1, 2, 4])
def test_live_table_is_flatnonzero_of_lengths_across_stack_plans(g):
    plans = []
    for i in range(g):
        part, meta = _padded(make_heterogeneous_matrix(300 + 3 * i, seed=i))
        plans.append(reduction_plan(part, meta))
    stacked = stack_plans(plans)
    placed = plan_to(stacked, "cpu")
    for field in ("dense", "ell", "coo"):
        seg = getattr(stacked, field)
        live = np.asarray(seg.live)
        lengths = np.asarray(seg.lengths)
        n_seg = lengths.shape[0] // g
        assert live.dtype == np.int64 and live.shape[0] == g
        np.testing.assert_array_equal(live[live >= 0],
                                      np.flatnonzero(lengths))
        for i in range(g):
            row = live[i][live[i] >= 0]
            assert np.all(live[i][row.size:] == -1)     # padding at the end
            assert np.all(row // n_seg == i)             # its own member
            np.testing.assert_array_equal(
                row - i * n_seg, np.asarray(getattr(plans[i], field).live)[0])
        on_dev = getattr(placed, field).live
        assert on_dev.dtype == torch.int64
        np.testing.assert_array_equal(on_dev.numpy(), live)


def test_segment_live_pads_short_members():
    live = segment_live([np.array([0, 2, 0, 1]), np.array([0, 0, 0, 0]),
                         np.array([5, 0, 0, 3])])
    np.testing.assert_array_equal(live, [[1, 3], [-1, -1], [8, 11]])
    assert segment_live([np.zeros(3)]).shape == (1, 0)


# ------------------------------------------------- against the reference ----
def _reference(a):
    import repro.core as rc
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    ref_part, ref_meta, _ = rc.analyze_and_partition(
        rc.csr_from_dense(a), rc.PartitionConfig(tile=64))
    return part, meta, ref_part, ref_meta


@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["hetero", "cora_signed"])
def test_hybrid_spmm_cuda_backend_on_cpu_matches_reference(kind,
                                                           ref_backend):
    import jax.numpy as jnp
    import repro.core as rc
    a = _graph(kind)
    part, meta, ref_part, ref_meta = _reference(a)
    assert part.ell.cols.shape[0] > 0
    b = np.random.default_rng(4).standard_normal((a.shape[1], 12)).astype(
        np.float32)
    got = tc.hybrid_spmm(part, b, meta=meta, backend="cuda", device="cpu")
    want = np.asarray(rc.hybrid_spmm(ref_part, jnp.asarray(b), meta=ref_meta,
                                     backend=ref_backend))
    np.testing.assert_allclose(got.numpy(), want, **SPMM_TOL)
    # and the port's own chain, bit for bit
    fused = tc.hybrid_spmm(part, b, meta=meta, backend="cuda",
                           ell_dispatch="fused", device="cpu")
    assert torch.equal(got, fused)


@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["hetero", "cora_signed"])
def test_gcn_forward_cuda_backend_on_cpu_matches_reference(kind,
                                                           ref_backend):
    import jax.numpy as jnp
    import repro.core as rc
    a = _graph(kind)
    part, meta, ref_part, ref_meta = _reference(a)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((a.shape[1], 20)).astype(np.float32)
    ws = [rng.uniform(-0.4, 0.4, (20, 16)).astype(np.float32),
          rng.uniform(-0.4, 0.4, (16, 5)).astype(np.float32)]
    got = tc.gcn_forward(part, x, ws, meta=meta, backend="cuda",
                         device="cpu")
    want = np.asarray(rc.gcn_forward(ref_part, jnp.asarray(x),
                                     [jnp.asarray(w) for w in ws],
                                     meta=ref_meta, backend=ref_backend))
    assert got.shape == (a.shape[0], 5)
    np.testing.assert_allclose(got.numpy(), want, **SPMM_TOL)


def test_ops_ragged_adds_onto_the_dense_rows_in_place():
    a = _graph("hetero")
    part, meta = _padded(a)
    plan = plan_to(reduction_plan(part, meta), "cpu")
    tp = tc.partition_to(tc.TriPartition(*(type(c)(*(np.asarray(x)[None]
                                                     for x in c))
                                           for c in part)), "cpu")
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, meta.n_cols, 8)).astype(np.float32))
    yd = ops.dense_tiles_matmul(tp, b, meta, plan)
    e = tp.ell
    want = parent_chain(e.cols, e.vals, e.tile_col, e.unit_k, e.rows,
                        b_tiles_of(b, meta), yd, plan.ell, meta)
    ops.reset_launch_counts()
    got = ops.ell_matmul(tp, b, meta, plan, yd)
    assert got is yd
    assert_same_bits(got, want)
    assert ops.launch_counts()["ragged_ell_spmm"] == 0      # CPU tensors


# ---------------------------------------------------------- on the card ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("graph", ["cora", "pubmed"])
def test_cuda_ell_rows_bitwise_at_paper_shapes(cuda_device, graph, g):
    """At the class-padded partitions of cora and pubmed, F = 128 and the
    class count: the kernel equals its plain version and the per-unit
    kernel + ``segment_sum`` + add, bit for bit, with one launch each."""
    from repro_torch.data.graphs import PAPER_DATASETS
    csr, _, _, _ = make_paper_dataset(graph, scale=1.0, seed=0)
    part, meta, _ = tc.analyze_and_partition(csr, tc.PartitionConfig(
        tile=64))
    part, meta = pad_to_class(part, meta,
                              ClassRegistry().classify(part, meta))
    plan = plan_to(stack_plans([reduction_plan(part, meta)] * g),
                   cuda_device)
    cols, vals, rows, tcol, uk = (
        torch.from_numpy(np.stack([np.asarray(x)] * g)).to(cuda_device)
        for x in part.ell)
    rng = np.random.default_rng(g)
    for f in (128, PAPER_DATASETS[graph].n_classes):
        bt = b_tiles_of(torch.from_numpy(rng.standard_normal(
            (g, meta.n_cols, f)).astype(np.float32)).to(cuda_device), meta
        ).contiguous()
        yd = torch.from_numpy(rng.standard_normal(
            (g, meta.n_padded_rows, f)).astype(np.float32)).to(cuda_device)
        ops.reset_launch_counts()
        got = ragged_ell_rows(cols, vals, tcol, uk, bt, plan.ell, yd.clone())
        per_unit = ragged_ell_spmm(cols, vals, tcol, uk, bt)
        assert ops.launch_counts()["ragged_ell_spmm"] == 2
        u, r = cols.shape[1], cols.shape[2]
        chain = yd + segment_sum(per_unit.reshape(g * u * r, f),
                                 plan.ell).reshape(yd.shape)
        assert torch.equal(got, chain)
        assert torch.equal(got, ragged_ell_rows_ref(cols, vals, tcol, uk, bt,
                                                    plan.ell, yd.clone()))
        assert torch.equal(per_unit, ragged_ell_spmm_ref(cols, vals, tcol,
                                                         uk, bt))


def _labels_class(graph, dev):
    """The class-padded partition of a paper graph at full size reordered
    by its planted labels (several K bands), its meta and plan on
    ``dev``."""
    from repro_torch.core.reorder import reorder
    csr, _, _, _ = make_paper_dataset(graph, scale=1.0, seed=0)
    csr = reorder(csr, "labels", labels=make_paper_dataset.last_labels)[0]
    part, meta, _ = tc.analyze_and_partition(csr, tc.PartitionConfig(
        tile=64))
    part, meta = pad_to_class(part, meta,
                              ClassRegistry().classify(part, meta))
    plan = plan_to(stack_plans([reduction_plan(part, meta)]), dev)
    ell = [torch.from_numpy(np.asarray(x)[None]).to(dev) for x in part.ell]
    return ell, meta, plan


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["cora", "pubmed"])
def test_cuda_banded_rows_bitwise_at_labels_shapes(cuda_device, graph):
    """Each unit to its band's K on the card: at the labels-reordered
    class (several bands), F = 128 and the class count, the kernel with
    the meta's segments equals its plain version bit for bit in every
    launch shape the autotuner may pick, and the Kmax pass
    (``segments=()``) at finite B. With every lane past its unit's band
    pointed at a B row of inf (col T - 1, which no lane inside a band
    reads), the result keeps the finite bits: those lanes are never read,
    where the Kmax pass turns rows to NaN."""
    from repro_torch.data.graphs import PAPER_DATASETS
    from repro_torch.kernels.autotune import candidates
    from repro_torch.kernels.bands import _bands_of, unit_bounds
    (cols, vals, _, tcol, uk), meta, plan = _labels_class(graph,
                                                          cuda_device)
    segs = meta.ell_segments
    assert len(segs) > 1
    _, u, _, kmax = cols.shape
    t = meta.tile
    bound = torch.from_numpy(unit_bounds(_bands_of(segs, u, kmax, 4))).to(
        cuda_device)
    inside = torch.arange(kmax, device=cuda_device) < bound[:, None, None]
    past = cols.clone()
    past[inside & (cols == t - 1)] = t - 2
    past[~inside.expand_as(cols)] = t - 1
    rng = np.random.default_rng(3)
    for f in (128, PAPER_DATASETS[graph].n_classes):
        bt = b_tiles_of(torch.from_numpy(rng.standard_normal(
            (1, meta.n_cols, f)).astype(np.float32)).to(cuda_device), meta
        ).contiguous()
        yd = torch.from_numpy(rng.standard_normal(
            (1, meta.n_padded_rows, f)).astype(np.float32)).to(cuda_device)
        args = (cols, vals, tcol, uk, bt, plan.ell)
        want = ragged_ell_rows_ref(*args, yd.clone(), segments=segs)
        assert torch.equal(want, ragged_ell_rows(*args, yd.clone()))
        for tune in candidates(f):
            assert torch.equal(ragged_ell_rows(
                *args, yd.clone(), segments=segs, tune=tune), want), tune
        assert torch.equal(ragged_ell_spmm(cols, vals, tcol, uk, bt,
                                           segments=segs),
                           ragged_ell_spmm_ref(cols, vals, tcol, uk, bt,
                                               segments=segs))
        poisoned = bt.clone()
        poisoned[:, :, t - 1, :] = float("inf")
        pargs = (past, vals, tcol, uk)
        clean = ragged_ell_rows(*pargs, bt, plan.ell, yd.clone(),
                                segments=segs)
        got = ragged_ell_rows(*pargs, poisoned, plan.ell, yd.clone(),
                              segments=segs)
        assert torch.equal(got, clean)
        assert torch.equal(got, ragged_ell_rows_ref(
            *pargs, poisoned, plan.ell, yd.clone(), segments=segs))
        assert bool(torch.isnan(ragged_ell_rows(
            *pargs, poisoned, plan.ell, yd.clone())).any())


def _labels_training(graph, dev):
    """A paper graph at full size reordered by its planted labels and
    not padded to a class (the partition training runs: every K run its
    own, 23 at cora, 52 at pubmed), its meta and plan on ``dev``."""
    from repro_torch.core.reorder import reorder
    csr, _, _, _ = make_paper_dataset(graph, scale=1.0, seed=0)
    csr = reorder(csr, "labels", labels=make_paper_dataset.last_labels)[0]
    part, meta, _ = tc.analyze_and_partition(csr, tc.PartitionConfig(
        tile=64))
    plan = plan_to(stack_plans([reduction_plan(part, meta)]), dev)
    ell = [torch.from_numpy(np.asarray(x)[None]).to(dev) for x in part.ell]
    return ell, meta, plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "bfloat16"),
                                    ("bfloat16", "float32")])
@pytest.mark.parametrize("graph", ["cora", "pubmed"])
def test_cuda_table_mode_bitwise_at_every_launch_shape(cuda_device, graph,
                                                       dtypes):
    """More than 4 K bands on the card (the kernel reads each unit's band
    K from the kept [U] table): bit for bit its plain version and the
    4-band launch, at every launch shape, F = 128 and 7, each type of
    vals and B; one table launch a call; the per-unit kernel likewise."""
    import importlib

    from repro_torch.kernels.autotune import candidates
    ell = importlib.import_module("repro_torch.kernels.ell_spmm")
    (cols, vals, _, tcol, uk), meta, plan = _labels_training(graph,
                                                             cuda_device)
    segs = meta.ell_segments
    assert len(segs) > 8
    vals = vals.to(getattr(torch, dtypes[0]))
    rng = np.random.default_rng(4)
    for f in (128, 7):
        b = torch.from_numpy(rng.standard_normal(
            (1, meta.n_cols, f)).astype(np.float32)).to(cuda_device)
        bt = b_tiles_of(b.to(getattr(torch, dtypes[1])), meta).contiguous()
        yd = torch.from_numpy(rng.standard_normal(
            (1, meta.n_padded_rows, f)).astype(np.float32)).to(cuda_device)
        args = (cols, vals, tcol, uk, bt, plan.ell)
        want = ragged_ell_rows_ref(*args, yd.clone(), segments=segs,
                                   max_bands=len(segs))
        assert torch.equal(ragged_ell_rows(*args, yd.clone(), segments=segs),
                           want)
        for cfg in candidates(f):
            if cfg["max_bands"] != 4:
                continue
            for mb in (8, len(segs)):
                before = sum(ell.table_launches.values())
                got = ragged_ell_rows(*args, yd.clone(), segments=segs,
                                      tune=dict(cfg, max_bands=mb))
                assert sum(ell.table_launches.values()) == before + 1
                assert torch.equal(got, want), (cfg, mb)
        assert torch.equal(
            ragged_ell_spmm(cols, vals, tcol, uk, bt, segments=segs,
                            max_bands=len(segs)),
            ragged_ell_spmm_ref(cols, vals, tcol, uk, bt, segments=segs,
                                max_bands=len(segs)))


@pytest.mark.cuda
def test_cuda_table_mode_replays_in_a_graph(cuda_device):
    """The table mode captured into a CUDA graph after one eager launch
    (which builds the table): the replay reads the kept table, with no
    copy, and gives the eager launch's bits."""
    (cols, vals, _, tcol, uk), meta, plan = _labels_training("cora",
                                                             cuda_device)
    segs = meta.ell_segments
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, meta.n_cols, 16)).astype(np.float32)).to(cuda_device)
    bt = b_tiles_of(b, meta).contiguous()
    out = torch.zeros((1, meta.n_padded_rows, 16), device=cuda_device)
    args = (cols, vals, tcol, uk, bt, plan.ell)
    want = ragged_ell_rows(*args, out.clone(), segments=segs, max_bands=64)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ragged_ell_rows(*args, out, segments=segs, max_bands=64)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
