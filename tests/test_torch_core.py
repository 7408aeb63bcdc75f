"""Host preprocessing of the PyTorch port against the JAX reference.

Partitioning, reordering, grouping, shape classes and class padding are
host numpy code in both packages and must agree EXACTLY: every
TriPartition array (values and dtypes), every PartitionMeta and
ShapeClass field. The port's deterministic reduction plans are held
bit for bit against summing every entry, including the padding
duplicates they drop.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.data.graphs as rg
import repro.engine.shape_class as rs
import repro_torch.core as tc
import repro_torch.data.graphs as tg
import repro_torch.engine.shape_class as ts
from repro_torch.convert import partition_from_numpy, weights_from_numpy
from repro_torch.core.formats import (SegmentPlan, partition_to, plan_to,
                                      reduction_plan, segment_live,
                                      segment_plan, segment_sum)

from conftest import (OVERFLOW_CFG, make_heterogeneous_matrix,
                      make_overflow_matrix)

torch.set_num_threads(2)

GRAPHS = {
    "hetero300_t64": (lambda: make_heterogeneous_matrix(300, seed=0),
                      dict(tile=64)),
    "hetero300_t128": (lambda: make_heterogeneous_matrix(300, seed=0),
                       dict()),
    "overflow": (make_overflow_matrix, OVERFLOW_CFG),
    "hetero520_s3": (lambda: make_heterogeneous_matrix(520, seed=3),
                     dict(tile=64)),
}


def assert_parts_equal(ref_part, port_part):
    for ref_comp, port_comp in zip(ref_part, port_part):
        assert type(ref_comp).__name__ == type(port_comp).__name__
        for field, a, b in zip(ref_comp._fields, ref_comp, port_comp):
            a = np.asarray(a)
            b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            assert a.dtype == b.dtype, field
            assert a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)


def assert_meta_equal(ref_meta, port_meta):
    assert dataclasses.asdict(ref_meta) == dataclasses.asdict(port_meta)


def both_partitions(name):
    make, cfg = GRAPHS[name]
    a = make()
    ref = rc.analyze_and_partition(rc.csr_from_dense(a),
                                   rc.PartitionConfig(**cfg))
    port = tc.analyze_and_partition(tc.csr_from_dense(a),
                                    tc.PartitionConfig(**cfg))
    return a, ref, port


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_exactly_equal(name):
    a, (p1, m1, r1), (p2, m2, r2) = both_partitions(name)
    assert_parts_equal(p1, p2)
    assert_meta_equal(m1, m2)
    assert len(r1) == len(r2)
    for b1, b2 in zip(r1, r2):
        assert (b1.band, b1.n_sparse_tiles, b1.kept_nnz, b1.padded_nnz,
                b1.emitted_dense) == (b2.band, b2.n_sparse_tiles,
                                      b2.kept_nnz, b2.padded_nnz,
                                      b2.emitted_dense)
        assert [dataclasses.astuple(g) for g in b1.groups] == [
            dataclasses.astuple(g) for g in b2.groups]
    rec = tc.partition_to_dense(p2, m2)
    np.testing.assert_array_equal(rec, a)


def test_overflow_spills_to_coo():
    _, _, (_, meta, _) = both_partitions("overflow")
    assert meta.nnz_ell > 0 and meta.nnz_coo >= 4 * 64


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_rows_equal(seed):
    rng = np.random.default_rng(seed)
    nnz = np.concatenate([rng.integers(0, 3, 40), rng.integers(20, 40, 30),
                          np.zeros(10, np.int64), rng.integers(0, 9, 50)])
    for tau in (0.3, 0.5, 1.0):
        g1 = rc.group_rows(nnz, tau=tau)
        g2 = tc.group_rows(nnz, tau=tau)
        assert [dataclasses.astuple(g) for g in g1] == [
            dataclasses.astuple(g) for g in g2]
        assert rc.grouping_density(nnz, g1) == tc.grouping_density(nnz, g2)


@pytest.mark.parametrize("strategy", ["rcm", "degree", "community",
                                      "identity"])
def test_reorder_equal(strategy):
    a = make_heterogeneous_matrix(200, seed=3)
    sym = np.abs(a) + np.abs(a).T
    c1, perm1, _ = rc.reorder(rc.csr_from_dense(sym), strategy)
    c2, perm2, _ = tc.reorder(tc.csr_from_dense(sym), strategy)
    np.testing.assert_array_equal(perm1, perm2)
    for x1, x2 in zip(c1[:3], c2[:3]):
        np.testing.assert_array_equal(x1, x2)
    assert rc.bandwidth(c1) == tc.bandwidth(c2)


@pytest.mark.parametrize("nnz,tau", [([5] * 100, 0.5),
                                     ([2] * 50 + [40] * 50, 0.5),
                                     ([1, 1, 1, 30, 30, 30], 0.3),
                                     ([0, 0, 3, 0, 7, 7, 1], 1.0)])
def test_padded_ops_equal(nnz, tau):
    g1, g2 = rc.group_rows(nnz, tau=tau), tc.group_rows(nnz, tau=tau)
    got = tc.grouping.padded_ops(nnz, g2)
    assert got == rc.grouping.padded_ops(nnz, g1)
    assert got == sum(g.n_rows * g.k for g in g2) >= sum(nnz)


def test_width_zero_group_entries_go_to_coo():
    """FIND_NNZ at p = 0.5 gives a skewed row width 0, so a group has
    k = 0. The reference skips such a group and loses its entries
    (A[191, 117] here); the port sends them to the COO residual, so its
    partition differs from the reference's by exactly those entries and
    covers A exactly."""
    a = make_heterogeneous_matrix(300, seed=0)
    cfg = dict(tile=64, delta=2.0, p=0.5, tau=0.8)
    ref_part, ref_meta, _ = rc.analyze_and_partition(
        rc.csr_from_dense(a), rc.PartitionConfig(**cfg))
    part, meta, reports = tc.analyze_and_partition(
        tc.csr_from_dense(a), tc.PartitionConfig(**cfg))
    assert any(g.k == 0 for r in reports for g in r.groups)
    np.testing.assert_array_equal(tc.partition_to_dense(part, meta), a)
    lost = a - np.asarray(rc.partition_to_dense(ref_part, ref_meta))
    assert list(zip(*np.nonzero(lost))) == [(191, 117)]
    # the dense tiles and the ELL are the reference's; the COO gains the
    # lost entry
    assert_parts_equal(ref_part[:2], part[:2])
    assert meta.nnz_coo == ref_meta.nnz_coo + 1
    coo = set(zip(part.coo.rows.tolist(), part.coo.cols.tolist()))
    assert coo == set(zip(ref_part.coo.rows.tolist(),
                          ref_part.coo.cols.tolist())) | {(191, 117)}


def test_paper_dataset_csr_equal():
    for name in ("cora", "pubmed"):
        a1, _, y1, st1 = rg.make_paper_dataset(name, scale=0.05)
        a2, x2, _, st2 = tg.make_paper_dataset(name, scale=0.05)
        for f1, f2 in zip(a1[:3], a2[:3]):
            np.testing.assert_array_equal(f1, f2)
        assert a1.shape == a2.shape
        assert dataclasses.asdict(st1) == dataclasses.asdict(st2)
        assert x2.shape == (a2.shape[0], st2.n_features)
    # the port's feature seed does not depend on PYTHONHASHSEED
    x_again = tg.make_paper_dataset("cora", scale=0.05)[1]
    np.testing.assert_array_equal(
        x_again, tg.make_paper_dataset("cora", scale=0.05)[1])


def _register_both(mats, policy_kw=None):
    """Classify + pad each matrix through both registries, in order."""
    policy_kw = policy_kw or {}
    reg1 = rs.ClassRegistry(rs.ShapePolicy(**policy_kw))
    reg2 = ts.ClassRegistry(ts.ShapePolicy(**policy_kw))
    out = []
    for a in mats:
        p1, m1, _ = rc.analyze_and_partition(rc.csr_from_dense(a),
                                             rc.PartitionConfig(tile=64))
        p2, m2, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
        n1 = rs.class_requirements(p1, m1, reg1.policy)
        n2 = ts.class_requirements(p2, m2, reg2.policy)
        assert dataclasses.asdict(n1) == dataclasses.asdict(n2)
        sc1, sc2 = reg1.classify_need(n1), reg2.classify_need(n2)
        assert dataclasses.asdict(sc1) == dataclasses.asdict(sc2)
        assert sc1.summary() == sc2.summary()
        assert_meta_equal(sc1.to_meta(), sc2.to_meta())
        pp1, pm1 = rs.pad_to_class(p1, m1, sc1)
        pp2, pm2 = ts.pad_to_class(p2, m2, sc2)
        assert_parts_equal(pp1, pp2)
        assert_meta_equal(pm1, pm2)
        out.append((a, p2, m2, sc2, pp2, pm2))
    assert reg1.stats() == reg2.stats()
    assert len(reg1.classes) == len(reg2.classes)
    return out


def test_class_registry_and_padding_equal_same_class(hetero300):
    # two graphs of one family land in one class in both packages
    res = _register_both([hetero300, make_heterogeneous_matrix(304, seed=1)])
    assert res[0][3] == res[1][3]
    for a, p, m, sc, pp, pm in res:
        rec = tc.partition_to_dense(pp, pm)[: a.shape[0], : a.shape[1]]
        np.testing.assert_array_equal(rec, a)
        back = ts.unpad_from_class(pp, pm, m)
        assert_parts_equal(p, back)


def test_class_registry_overflow_and_new_class():
    res = _register_both([make_overflow_matrix(),
                          make_heterogeneous_matrix(300, seed=0),
                          make_heterogeneous_matrix(900, seed=2)],
                         dict(fit_slack=2.0))
    assert len({r[3] for r in res}) >= 2


def test_class_helpers_equal():
    for x in (0, 1, 3, 17, 64, 200):
        assert rs.round_up_pow2(x, 4) == ts.round_up_pow2(x, 4)
        assert (rs.round_up_ladder(x, rs.DEFAULT_K_LADDER)
                == ts.round_up_ladder(x, ts.DEFAULT_K_LADDER))
    runs = ((16, 3), (8, 10), (4, 1), (2, 7), (1, 30))
    from repro.kernels.ell_spmm import merge_bands as ref_merge
    from repro_torch.kernels.ell_spmm import merge_bands
    for mb in (1, 2, 4, 8):
        assert ref_merge(runs, mb) == merge_bands(runs, mb)
    a = make_heterogeneous_matrix(300, seed=0)
    p1, m1, _ = rc.analyze_and_partition(rc.csr_from_dense(a),
                                         rc.PartitionConfig(tile=64))
    p2, m2, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                         tc.PartitionConfig(tile=64))
    assert (dataclasses.asdict(rs.shape_class_of(p1, m1))
            == dataclasses.asdict(ts.shape_class_of(p2, m2)))


def test_convert_round_trip():
    _, (p1, m1, _), _ = both_partitions("hetero300_t64")
    p2, m2 = partition_from_numpy(p1, m1)
    assert_parts_equal(p1, p2)
    assert_meta_equal(m1, m2)
    assert type(m2).__module__ == "repro_torch.core.formats"
    ws = [np.arange(6, dtype=np.float64).reshape(2, 3)]
    (w,) = weights_from_numpy(ws, device="cpu")
    assert w.dtype == torch.float32 and torch.equal(
        w, torch.arange(6, dtype=torch.float32).reshape(2, 3))


# ------------------------------------------------ deterministic reduction ----
def _full_plan(dest, n_seg):
    """A plan that sums every entry (no padding duplicate dropped)."""
    s = segment_plan(dest, n_seg)
    return SegmentPlan(torch.from_numpy(s.order),
                       torch.from_numpy(s.lengths), s.n_entries,
                       torch.from_numpy(s.offsets),
                       torch.from_numpy(s.live))


def test_segment_sum_matches_index_add():
    rng = np.random.default_rng(0)
    dest = rng.integers(0, 9, 50)
    data = torch.from_numpy(rng.standard_normal((50, 5)).astype(np.float32))
    got = segment_sum(data, _full_plan(dest, 12))
    want = torch.zeros(12, 5).index_add_(0, torch.from_numpy(dest), data)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[9:], torch.zeros(3, 5))
    empty = SegmentPlan(torch.zeros(0, dtype=torch.int64),
                        torch.zeros(4, dtype=torch.int64), 50,
                        torch.zeros(5, dtype=torch.int64),
                        torch.from_numpy(segment_live([np.zeros(4)])))
    assert torch.equal(segment_sum(data, empty), torch.zeros(4, 5))


def assert_same_bits(a, b):
    """Bitwise equal, NaN payloads aside."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def test_plan_drops_padding_duplicates_bit_exactly():
    """Dropping all-zero padding duplicates never changes a bit, even
    where B holds NaN, inf or -0.0 in the rows the padding reads."""
    res = _register_both([make_heterogeneous_matrix(300, seed=0)])
    _, _, m, sc, pp, pm = res[0]
    part = partition_to(pp, "cpu")
    plan = plan_to(reduction_plan(pp, pm), "cpu")
    # the class pads both slices; the plan keeps one entry of each padding
    assert pm.n_dense_tiles > m.n_dense_tiles + 1
    assert plan.dense.order.numel() == m.n_dense_tiles + 1
    assert sc.coo_nnz > m.nnz_coo + 1
    assert plan.coo.order.numel() == m.nnz_coo + 1
    rng = np.random.default_rng(1)
    b = rng.standard_normal((sc.n_col_tiles * sc.tile, 6)).astype(np.float32)
    for special in (0.0, -0.0, np.nan, np.inf):
        b[0, :3] = special
        b[1, 3:] = -0.0
        bt = torch.from_numpy(b).reshape(1, sc.n_col_tiles, sc.tile, 6)
        prod = torch.matmul(part.dense.tiles,
                            bt[0][part.dense.tile_col.long()])
        flat = prod.reshape(prod.shape[0], -1)
        dense_all = _full_plan(part.dense.tile_row.numpy(), sc.n_row_tiles)
        assert_same_bits(segment_sum(flat, plan.dense),
                         segment_sum(flat, dense_all))
        msgs = part.coo.vals[:, None] * torch.from_numpy(b)[
            part.coo.cols.long()]
        coo_all = _full_plan(part.coo.rows.numpy(), pm.n_padded_rows)
        assert_same_bits(segment_sum(msgs, plan.coo),
                         segment_sum(msgs, coo_all))


def test_scatter_ell_partials_matches_reference():
    _, (p1, m1, _), (p2, m2, _) = both_partitions("hetero300_t64")
    u, r = p1.ell.rows.shape
    rng = np.random.default_rng(0)
    partials = rng.standard_normal((u * r, 7)).astype(np.float32)
    want = np.asarray(rc.scatter_ell_partials(
        np.asarray(p1.ell.rows).reshape(-1), partials, m1))
    got = tc.scatter_ell_partials(torch.from_numpy(p2.ell.rows.reshape(-1)),
                                  torch.from_numpy(partials), m2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
