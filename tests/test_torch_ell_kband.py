"""The ELL kernels' K bounds: the ragged kernel runs each unit to its
band's K (the TPU kernel ``_ragged_ell_kernel``'s band switch), the
fixed-K row kernel each unit to its bucket's K, in one launch a layer.

Held against the JAX reference on the CPU:

- the port's band table (``kernels.bands``) equals the reference's
  ``_bands_of`` / ``_band_tables`` for the reference's edge-case graphs,
  the paper graphs reordered by labels and hand-made runs, at
  ``max_bands`` 1-4;
- the band-bounded plain version against the reference's
  ``ragged_ell_spmm(..., segments=, gu=1, interpret=True)``: within
  ``KERNEL_TOL`` (the same float32 products; XLA may fuse the
  multiply-add) at finite B, with the same NaN and inf masks where B is
  non-finite at a lane in [unit_k, band K) (read, multiplied by 0) and at
  a lane in [band K, Kmax) (never read);

and within the port, bit for bit:

- ``segments=()`` is the masked Kmax pass the port ran before;
- at finite B the band-bounded result equals the Kmax-bounded one on
  every dispatch and both backends;
- the one-launch fixed-K plain version equals the per-bucket ``ell_spmm``
  + ``scatter_ell_partials`` chain of "fused" and "loop", at G = 1 and a
  stacked G = 2, with rows that several buckets reach;
- ``plan.ell`` sums each row's unit rows bucket after bucket, each
  bucket's in unit order, and the plan's bucket table survives stacking
  and placement.

The kernel pass's band rule and the launch contracts' band tables are
checked here too. The kernels themselves run on the card
(``tests/test_torch_ell_bands.py``'s and ``test_torch_kernels.py``'s
``cuda`` tests, and ``chip_smoke.py``).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as rc
import repro_torch.core as tc
from repro_torch.analysis.static.kernel_pass import check_bands
from repro_torch.core.formats import (PartitionMeta, RaggedEll, bucket_plan,
                                      ell_buckets, plan_to, reduction_plan,
                                      scatter_ell_partials, stack_plans)
from repro_torch.core.reorder import reorder
from repro_torch.data.graphs import make_paper_dataset
from repro_torch.engine.shape_class import ClassRegistry, pad_to_class
from repro_torch.kernels import bands as kb
from repro_torch.kernels import ops
from repro_torch.kernels.ell_spmm import (ell_contract, ell_spmm_rows,
                                          ragged_ell_contract, ragged_ell_spmm)
from repro_torch.kernels.ref import (_gather_b_tiles, ell_spmm_ref,
                                     ell_spmm_rows_ref, ragged_ell_spmm_ref)

from conftest import (OVERFLOW_CFG, make_heterogeneous_matrix,
                      make_overflow_matrix)

torch.set_num_threads(2)

ref_ell = importlib.import_module("repro.kernels.ell_spmm")

KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
DISPATCHES = ("ragged", "fused", "loop")


def _single_k_matrix(n=192):
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


def _labels_partition(graph, scale, pad=False):
    """A paper graph reordered by its planted labels (the paper's first
    step), partitioned, optionally padded to its shape class."""
    csr, _, _, _ = make_paper_dataset(graph, scale=scale, seed=0)
    csr = reorder(csr, "labels", labels=make_paper_dataset.last_labels)[0]
    part, meta, _ = tc.analyze_and_partition(csr, tc.PartitionConfig(
        tile=64))
    if pad:
        part, meta = pad_to_class(part, meta,
                                  ClassRegistry().classify(part, meta))
    return part, meta


def assert_same_bits(a, b):
    """Bitwise equal (the sign of zero included), NaN payloads aside."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def kmax_pass(cols, vals, tile_col, unit_k, b_tiles):
    """The port's ragged plain version before the K bands: every unit to
    Kmax, the values masked by ``unit_k`` (grouped operands)."""
    g, u, r, kmax = cols.shape
    f = b_tiles.shape[-1]
    bt = _gather_b_tiles(b_tiles, tile_col)
    acc = torch.zeros((g, u, r, f), dtype=torch.float32)
    for kk in range(kmax):
        idx = cols[..., kk].long()[..., None].expand(g, u, r, f)
        rows = torch.gather(bt, 2, idx)
        v = torch.where((kk < unit_k)[..., None], vals[..., kk],
                        torch.zeros((), dtype=vals.dtype))
        acc = acc + v[..., None].float() * rows.float()
    return acc


# ----------------------------------------------------------- band table ----
def _runs_cases():
    cases = {}
    for name in sorted(EDGE_CASES):
        _, _, meta, _, ref_meta = _edge(name)
        assert meta.ell_segments == ref_meta.ell_segments
        u = sum(n for _, n in meta.ell_segments)
        kmax = max((k for k, _ in meta.ell_segments), default=0)
        cases[name] = (meta.ell_segments, u, kmax)
    for graph in ("cora", "pubmed"):
        _, meta = _labels_partition(graph, 0.3)
        u = sum(n for _, n in meta.ell_segments)
        cases[f"{graph}@labels"] = (meta.ell_segments, u,
                                    meta.ell_segments[0][0])
    runs = ((9, 2), (7, 1), (7, 3), (4, 0), (2, 5), (1, 1))
    cases["hand"] = (runs, 12, 9)
    cases["hand_clamped"] = (runs, 12, 6)            # K past the slab
    cases["hand_ascending"] = (runs[::-1], 12, 9)    # legacy order
    cases["hand_short"] = (runs[:2], 12, 9)          # does not cover U
    return cases


RUNS = _runs_cases()


@pytest.mark.parametrize("max_bands", [1, 2, 3, 4])
@pytest.mark.parametrize("case", sorted(RUNS))
def test_band_table_equals_the_references(case, max_bands):
    segments, u, kmax = RUNS[case]
    mine = kb._bands_of(segments, u, kmax, max_bands)
    want = ref_ell._bands_of(segments, u, kmax, max_bands)
    assert mine == want
    assert kb._band_tables(mine) == ref_ell._band_tables(want)
    assert len(mine) <= max_bands
    if u:
        bound = kb.unit_bounds(mine)
        ks, _, offs = ref_ell._band_tables(want)
        assert bound.tolist() == [ks[sum(i >= o for o in offs)]
                                  for i in range(u)]


def test_labels_classes_have_several_bands():
    """The reordered graphs are what the bands are for: several K runs
    and a widest band far wider than most units' K."""
    for graph in ("cora", "pubmed"):
        _, meta = _labels_partition(graph, 0.3)
        bands = kb._bands_of(meta.ell_segments, sum(
            n for _, n in meta.ell_segments), meta.ell_segments[0][0], 4)
        assert len(bands) == 4
        lanes = sum(k * n for k, n in bands)
        assert lanes < 0.7 * bands[0][0] * sum(n for _, n in bands)


def test_max_bands_out_of_range_raises_on_every_device():
    cols, vals, tcol, unit_k, b, segments = synth(seed=0)
    for mb in (0, -1):
        with pytest.raises(ValueError, match="max_bands"):
            ragged_ell_spmm(cols, vals, tcol, unit_k, b, segments=segments,
                            max_bands=mb, device="cpu")
        with pytest.raises(ValueError, match="max_bands"):
            ragged_ell_contract(1, 12, 4, 9, 3, 16, 8, segments=segments,
                                max_bands=mb)
    # past 4 bands the runs merge as the reference merges them
    got = ragged_ell_spmm(cols, vals, tcol, unit_k, b, segments=segments,
                          max_bands=5, device="cpu")
    torch.testing.assert_close(got, _pallas(cols, vals, tcol, unit_k, b,
                                            segments, 5), **KERNEL_TOL)
    assert ragged_ell_contract(1, 14, 4, 9, 3, 16, 8, segments=segments,
                               max_bands=5)["bands"] == ref_ell._bands_of(
        segments, 14, 9, 5)


# ------------------------------------------------- synthetic unit arrays ----
SYNTH_RUNS = ((9, 2), (7, 4), (4, 3), (2, 2), (1, 3))


def synth(seed, g=None, r=4, t=16, nct=3, f=8, runs=SYNTH_RUNS):
    """A ragged unit array over descending K runs (units with unit_k
    below their run's K, zero lanes past unit_k, padded lanes reading col
    0), B with -0 entries; returns (cols, vals, tile_col, unit_k, b,
    runs)."""
    rng = np.random.default_rng(seed)
    lead = () if g is None else (g,)
    u = sum(n for _, n in runs)
    kmax = runs[0][0]
    run_k = np.repeat([k for k, _ in runs], [n for _, n in runs])
    unit_k = np.where(rng.random(lead + (u,)) < 0.6, run_k,
                      rng.integers(0, run_k + 1, lead + (u,)))
    live = np.arange(kmax) < unit_k[..., None, None]
    cols = (rng.integers(1, t, lead + (u, r, kmax)) * live).astype(np.int32)
    vals = (rng.standard_normal(lead + (u, r, kmax)) * live).astype(
        np.float32)
    tcol = rng.integers(0, nct, lead + (u,)).astype(np.int32)
    b = rng.standard_normal(lead + (nct, t, f)).astype(np.float32)
    b[rng.random(b.shape) < 0.2] = -0.0
    return (*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        cols, vals, tcol, unit_k.astype(np.int32), b)), runs)


def _pallas(cols, vals, tcol, unit_k, b, segments, max_bands):
    return torch.from_numpy(np.array(ref_ell.ragged_ell_spmm(
        *(jnp.asarray(x.numpy()) for x in (cols, vals, tcol, unit_k, b)),
        segments=tuple(segments), max_bands=max_bands, gu=1,
        interpret=True)))


@pytest.mark.parametrize("max_bands", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_banded_ref_matches_the_pallas_kernel_at_finite_b(seed, max_bands):
    cols, vals, tcol, unit_k, b, runs = synth(seed)
    got = ragged_ell_spmm_ref(cols, vals, tcol, unit_k, b, segments=runs,
                              max_bands=max_bands)
    want = _pallas(cols, vals, tcol, unit_k, b, runs, max_bands)
    torch.testing.assert_close(got, want, **KERNEL_TOL)
    assert torch.equal(got, ragged_ell_spmm(
        cols, vals, tcol, unit_k, b, segments=runs, max_bands=max_bands,
        device="cpu"))


def _poison(cols, tcol, unit_k, b, runs, max_bands, where):
    """Make B non-finite at one lane of one unit: ``where`` "inside" a
    lane in [unit_k, band K) (read, its value masked to 0: 0 * inf =
    NaN reaches the sum), "past" a lane in [band K, Kmax) (never read).
    The lane's column is made unique to it so nothing else reads it."""
    u = unit_k.shape[0]
    bound = kb.unit_bounds(kb._bands_of(runs, u, cols.shape[-1], max_bands))
    t = b.shape[1]
    for i in range(u):
        uk, band = int(unit_k[i]), int(bound[i])
        lo, hi = (uk, band) if where == "inside" else (band, cols.shape[-1])
        if lo < hi:
            cols[i, 0, lo] = t - 1          # no other lane reads col T - 1
            b[int(tcol[i]), t - 1, :2] = torch.tensor([np.inf, -np.inf])
            b[int(tcol[i]), t - 1, 2] = np.nan
            return i
    raise AssertionError(f"no unit has a lane {where} its band")


@pytest.mark.parametrize("where", ["inside", "past"])
@pytest.mark.parametrize("max_bands", [2, 4])
def test_banded_ref_has_the_pallas_kernels_nonfinite_masks(max_bands, where):
    cols, vals, tcol, unit_k, b, runs = synth(3)
    cols[cols == b.shape[1] - 1] = 0
    unit = _poison(cols, tcol, unit_k, b, runs, max_bands, where)
    got = ragged_ell_spmm_ref(cols, vals, tcol, unit_k, b, segments=runs,
                              max_bands=max_bands)
    want = _pallas(cols, vals, tcol, unit_k, b, runs, max_bands)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], **KERNEL_TOL)
    kmax = kmax_pass(cols[None], vals[None], tcol[None], unit_k[None],
                     b[None])[0]
    # the Kmax pass reads every lane: NaN at the unit's row either way;
    # the band bound keeps it out where the lane lies past the band
    assert bool(torch.isnan(kmax[unit, 0]).any())
    assert bool(torch.isnan(got[unit, 0]).any()) == (where == "inside")


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("g", [None, 2])
def test_no_segments_is_the_kmax_pass_bit_for_bit(g, nonfinite):
    cols, vals, tcol, unit_k, b, _ = synth(5, g=g)
    if nonfinite:
        b[..., 0, :] = np.inf                # padded lanes read col 0
    lead = (lambda x: x) if g else (lambda x: x[None])
    want = kmax_pass(*(lead(x) for x in (cols, vals, tcol, unit_k, b)))
    got = ragged_ell_spmm(cols, vals, tcol, unit_k, b, device="cpu")
    assert_same_bits(lead(got), want)
    assert_same_bits(lead(ragged_ell_spmm_ref(cols, vals, tcol, unit_k,
                                              b)), want)
    assert bool(torch.isnan(want).any()) == nonfinite


@pytest.mark.parametrize("max_bands", [1, 2, 3, 4])
@pytest.mark.parametrize("g", [None, 3])
def test_banded_equals_kmax_bit_for_bit_at_finite_b(g, max_bands):
    cols, vals, tcol, unit_k, b, runs = synth(7, g=g)
    assert_same_bits(
        ragged_ell_spmm(cols, vals, tcol, unit_k, b, segments=runs,
                        max_bands=max_bands, device="cpu"),
        ragged_ell_spmm(cols, vals, tcol, unit_k, b, device="cpu"))


# --------------------------------------------------------- whole SpMMs -----
def _spmm_cases():
    out = {name: _edge(name)[1:3] for name in ("mixed_k", "single_k",
                                               "ell_overflow")}
    out["cora@labels"] = _labels_partition("cora", 0.3)
    out["cora@labels class"] = _labels_partition("cora", 0.3, pad=True)
    out["pubmed@labels class"] = _labels_partition("pubmed", 0.2, pad=True)
    return out


SPMM_CASES = _spmm_cases()


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("case", sorted(SPMM_CASES))
def test_every_dispatch_equals_the_kmax_pass_at_finite_b(case, backend):
    part, meta = SPMM_CASES[case]
    rng = np.random.default_rng(11)
    b = rng.standard_normal((meta.n_cols, 9)).astype(np.float32)
    b[rng.random(b.shape) < 0.1] = -0.0
    whole = dataclasses.replace(meta, ell_segments=())
    want = tc.hybrid_spmm(part, b, meta=whole, backend="cuda",
                          device="cpu")
    for d in DISPATCHES:
        assert_same_bits(tc.hybrid_spmm(part, b, meta=meta, backend=backend,
                                        ell_dispatch=d, device="cpu"), want)


@pytest.mark.parametrize("case", ["cora@labels", "pubmed@labels class"])
def test_ragged_matches_the_pallas_path_with_a_nonfinite_row(case):
    """A whole SpMM through ``ops.ell_matmul`` (it passes the meta's
    segments) against the reference's Pallas path with one B row
    non-finite: the same NaN and inf masks, the rest within tolerance."""
    part, meta = SPMM_CASES[case]
    rp = rc.TriPartition(*(type(c)(*(np.asarray(x) for x in c))
                           for c in _ref_types(part)))
    b = np.random.default_rng(2).standard_normal((meta.n_cols, 6)).astype(
        np.float32)
    b[5, :2] = (np.inf, np.nan)
    b[0, 2] = np.inf                 # padded lanes of tile 0 read col 0
    got = tc.hybrid_spmm(part, b, meta=meta, backend="cuda",
                         device="cpu").numpy()
    want = np.asarray(rc.hybrid_spmm(rp, jnp.asarray(b), meta=_ref_meta(
        meta), backend="pallas", ell_tune={"gu": 1}))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    assert not fin.all()


def _ref_types(part):
    """The port's partition leaves as the reference's containers."""
    from repro.core import formats as rf
    return (rf.DenseTiles(*part.dense), rf.RaggedEll(*part.ell),
            rf.CooResidual(*part.coo))


def _ref_meta(meta):
    from repro.core import formats as rf
    return rf.PartitionMeta(**{f.name: getattr(meta, f.name)
                               for f in dataclasses.fields(meta)})


# --------------------------------------------- fixed K, one launch a layer ----
def rows_inputs(seed, g, r=4, t=16, nct=3, nrt=2, f=7):
    """A slab over ``SYNTH_RUNS`` whose unit rows land on a few padded
    rows (several buckets reach most of them), its meta, plan, B and the
    dense rows ``yd`` (never -0), stacked over ``g`` members."""
    cols, vals, tcol, unit_k, b, runs = synth(seed, g=g, r=r, t=t, nct=nct,
                                              f=f)
    u = unit_k.shape[-1]
    meta = PartitionMeta(nrt * t, nct * t, t, (1, 2, 4, 7, 9), nrt, nct, 0,
                         0, 0, 0, 0, (0.5, 0.01), ell_segments=runs)
    p = meta.n_padded_rows
    rng = np.random.default_rng(seed + 100)
    rows = rng.choice(p, 6, replace=False)[rng.integers(0, 6, (g, u, r))]
    rows[rng.random(rows.shape) < 0.15] = meta.ell_sentinel_row
    ell = RaggedEll(cols, vals, torch.from_numpy(rows.astype(np.int32)),
                    tcol, unit_k)
    plan = plan_to(stack_plans([reduction_plan(
        _part(RaggedEll(*(x[i] for x in ell)), t), meta) for i in range(g)]),
        "cpu")
    yd = torch.from_numpy(rng.standard_normal((g, p, f)).astype(np.float32))
    return ell, b, yd, plan, meta


def _part(ell, t):
    from repro_torch.core.formats import (CooResidual, DenseTiles,
                                          TriPartition)
    return TriPartition(
        DenseTiles(np.zeros((0, t, t), np.float32), np.zeros(0, np.int32),
                   np.zeros(0, np.int32)),
        RaggedEll(*(x.numpy() for x in ell)),
        CooResidual(np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32)))


def per_bucket_chain(ell, b, yd, plan, meta, dispatch):
    """What "fused"/"loop" ran before: per-bucket ``ell_spmm_ref``
    products, their scatter (at once, or bucket by bucket), ``yd + ye``."""
    g, f = b.shape[0], b.shape[-1]
    buckets = ell_buckets(ell, meta.ell_segments)
    prods = [ell_spmm_ref(bk.cols, bk.vals, bk.tile_col, b)
             for bk in buckets]
    if dispatch == "fused":
        ye = scatter_ell_partials(
            ell.rows.reshape(g, -1),
            torch.cat(prods, dim=1).reshape(g, -1, f), meta, plan=plan.ell)
    else:
        rows = [bk.rows.reshape(g, -1) for bk in buckets]
        ye = scatter_ell_partials(
            rows, [p.reshape(g, -1, f) for p in prods], meta,
            plan=[bucket_plan(r, meta, "cpu") for r in rows])
    return yd + ye


@pytest.mark.parametrize("dispatch", ["fused", "loop"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_one_launch_ref_equals_the_per_bucket_chain(seed, g, dispatch):
    ell, b, yd, plan, meta = rows_inputs(seed, g)
    got = ell_spmm_rows_ref(ell.cols, ell.vals, ell.tile_col, b, plan.ell,
                            yd.clone(), plan.ell_bucket_k)
    assert_same_bits(got, per_bucket_chain(ell, b, yd, plan, meta,
                                           dispatch))
    assert_same_bits(got, ell_spmm_rows(ell.cols, ell.vals, ell.tile_col,
                                        b, plan.ell, yd.clone(),
                                        plan.ell_bucket_k, device="cpu"))


def test_one_launch_ref_reads_no_lane_past_a_bucket():
    """A non-finite B row read only past units' bucket K stays out of the
    fixed-K rows, as it stays out of the per-bucket chain."""
    ell, b, yd, plan, meta = rows_inputs(4, 1)
    # lanes past a bucket's K hold col 0 (padding); make col 0 of every
    # tile inf and keep live lanes off it
    b[:, :, 0, :] = np.inf
    got = ell_spmm_rows_ref(ell.cols, ell.vals, ell.tile_col, b, plan.ell,
                            yd.clone(), plan.ell_bucket_k)
    want = per_bucket_chain(ell, b, yd, plan, meta, "fused")
    assert_same_bits(got, want)


@pytest.mark.parametrize("g", [1, 2])
def test_plan_sums_rows_bucket_after_bucket_in_unit_order(g):
    ell, _, _, plan, meta = rows_inputs(2, g)
    n = ell.rows.shape[-1]
    u = ell.unit_k.shape[-1]
    bucket = np.repeat(np.arange(len(meta.ell_segments)),
                       [c for _, c in meta.ell_segments])
    order, offsets = plan.ell.order.numpy(), plan.ell.offsets.numpy()
    shared = 0
    for s in range(offsets.shape[0] - 1):
        e = order[offsets[s]:offsets[s + 1]]
        assert np.all(np.diff(e) > 0)                  # unit order
        bk = bucket[(e // n) % u]
        assert np.all(np.diff(bk) >= 0)                # bucket after bucket
        shared += len(set(bk.tolist())) > 1
    assert shared > 0, "fixture must reach rows from several buckets"


@pytest.mark.parametrize("g", [1, 2, 4])
def test_bucket_table_stacks_and_places(g):
    plans, metas = [], []
    reg = ClassRegistry()
    for i in range(g):
        a = make_heterogeneous_matrix(300 + 4 * i, seed=i)
        part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                                 tc.PartitionConfig(tile=64))
        part, meta = pad_to_class(part, meta, reg.classify(part, meta))
        plans.append(reduction_plan(part, meta))
        metas.append(meta)
    assert len({m.ell_segments for m in metas}) == 1
    want = np.repeat(*zip(*metas[0].ell_segments))
    for p in plans:
        np.testing.assert_array_equal(p.ell_bucket_k, want)
        assert p.ell_bucket_k.dtype == np.int32
    placed = plan_to(stack_plans(plans), "cpu")
    assert placed.ell_bucket_k.dtype == torch.int32
    np.testing.assert_array_equal(placed.ell_bucket_k.numpy(), want)
    assert placed.ell.live.shape[0] == g


def test_ops_fixed_dispatch_is_one_call_a_layer():
    part, meta = SPMM_CASES["cora@labels"]
    assert len(meta.ell_segments) > 4
    b = np.random.default_rng(3).standard_normal((meta.n_cols, 5)).astype(
        np.float32)
    for d in ("fused", "loop"):
        ops.reset_entry_counts()
        y = tc.hybrid_spmm(part, b, meta=meta, ell_dispatch=d, device="cpu")
        calls = ops.entry_counts()
        assert calls.get("ell_spmm_rows") == 1 and not calls.get("ell_spmm")
        assert torch.equal(y, tc.hybrid_spmm(part, b, meta=meta,
                                             device="cpu"))


# ------------------------------------------------ contracts and the audit ----
def test_contracts_carry_the_band_tables():
    runs = SYNTH_RUNS
    c = ragged_ell_contract(1, 14, 4, 9, 3, 16, 8, segments=runs)
    assert c["bands"] == kb._bands_of(runs, 14, 9, 4)
    assert c["band_ks"] == tuple(k for k, _ in c["bands"])
    assert sum(c["band_counts"]) == 14 and len(c["band_offs"]) == 3
    f = ell_contract(1, 14, 4, 9, 3, 16, 8, segments=runs)
    assert f["bands"] == runs and f["shapes"]["bucket_k"] == (14,)
    assert check_bands(c) == [] and check_bands(f) == []
    assert ragged_ell_contract(1, 14, 4, 9, 3, 16, 8)["bands"] == ((9, 14),)


@pytest.mark.parametrize("bands,rule", [
    (((4, 6), (7, 4), (1, 4)), "descend"),
    (((12, 6), (4, 8)), "outside"),
    (((9, 6), (4, 6)), "cover"),
    (((9, 4), (7, 4), (4, 2), (2, 2), (1, 2)), "at most"),
])
def test_kernel_pass_rejects_a_bad_band_table(bands, rule):
    c = dict(ragged_ell_contract(1, 14, 4, 9, 3, 16, 8, segments=SYNTH_RUNS),
             bands=bands)
    found = check_bands(c)
    assert found and all(f.rule == "bands" and f.severity == "error"
                         for f in found)
    assert any(rule in f.message for f in found)
