"""The dense engine with its sum over ``tile_row`` folded in.

``bsr_spmm_rows`` is the dense engine as the port's main path runs it:
each row tile's per-tile products summed in the order of the host-built
``SegmentPlan`` (``plan.dense``). On the CPU it runs its plain version
(``bsr_spmm_ref`` followed by ``segment_sum``); that is held against the
reference's dense route, ``repro.kernels.ops.dense_tiles_matmul`` with
the Pallas kernel in interpret mode, on a cora-like partition and a
class-padded one, alone and as a stacked group of 4. Tolerance: float32
``rtol=1e-5, atol=1e-6`` of the magnitude of the sum,
``|got - want| <= atol + rtol * (|tiles| @ |B| summed per row tile)``:
the products are the same, but the two frameworks add the 64 terms of
each dot product in another order, and where they cancel the rounding
is relative to the terms, not to the result (as for ``tile_matmul``).

Tests marked ``cuda`` launch the kernel (one launch for the whole
group); they skip without a card.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.formats import (b_tiles_of, plan_to,
                                      reduction_plan, segment_offsets,
                                      segment_plan, segment_sum, stack_plans)
from repro_torch.data.graphs import make_paper_dataset
from repro_torch.engine.shape_class import ClassRegistry, pad_to_class
from repro_torch.kernels import _build, ops
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_rows
from repro_torch.kernels.ref import bsr_spmm_rows_ref

from conftest import make_heterogeneous_matrix

torch.set_num_threads(2)

KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)


def _partition(kind):
    """(host partition, meta): a cora-like graph as partitioned, or a
    class-padded partition (all-zero duplicate tiles on row tile 0)."""
    if kind == "cora":
        csr, _, _, _ = make_paper_dataset("cora", scale=0.2, seed=0)
        return tc.analyze_and_partition(csr, tc.PartitionConfig(tile=64))[:2]
    a = make_heterogeneous_matrix(300, seed=0)
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    return pad_to_class(part, meta, ClassRegistry().classify(part, meta))


def _stacked(part, meta, g, f, seed=0):
    """The dense leaves stacked G times, B [G, n_cols, F] and the
    stacked host plan."""
    plan = reduction_plan(part, meta)
    tiles, tile_row, tile_col = (np.stack([np.asarray(x)] * g)
                                 for x in part.dense)
    b = np.random.default_rng(seed).standard_normal(
        (g, meta.n_cols, f)).astype(np.float32)
    return tiles, tile_row, tile_col, b, stack_plans([plan] * g)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("kind", ["cora", "padded"])
def test_dense_rows_plain_matches_reference_dense_route(kind, g):
    import jax.numpy as jnp
    from repro.core import formats as rf
    from repro.kernels import ops as rops
    part, meta = _partition(kind)
    assert meta.n_dense_tiles > 0
    tiles, tile_row, tile_col, b, plan = _stacked(part, meta, g, 7, seed=g)
    bt = b_tiles_of(torch.from_numpy(b), meta)
    got = bsr_spmm_rows(*_t(tiles, tile_col), bt,
                        plan_to(plan, "cpu").dense, device="cpu")
    assert got.shape == (g, meta.n_row_tiles, meta.tile, 7)
    ref_part = rf.TriPartition(
        dense=rf.DenseTiles(*(jnp.asarray(np.asarray(x))
                              for x in part.dense)),
        ell=part.ell, coo=part.coo)
    ref_meta = rf.PartitionMeta(**{k: getattr(meta, k) for k in (
        "n_rows", "n_cols", "tile", "ell_ks", "n_row_tiles", "n_col_tiles",
        "n_dense_tiles", "nnz_dense", "nnz_ell", "nnz_ell_padded", "nnz_coo",
        "density_thresholds", "ell_segments")})
    scale = bsr_spmm_rows(*_t(np.abs(tiles), tile_col), bt.abs(),
                          plan_to(plan, "cpu").dense, device="cpu")
    for i in range(g):
        want = np.asarray(rops.dense_tiles_matmul(ref_part,
                                                  jnp.asarray(b[i]),
                                                  ref_meta))
        err = np.abs(got[i].reshape(-1, 7).numpy() - want)
        bound = (KERNEL_TOL["atol"]
                 + KERNEL_TOL["rtol"] * scale[i].reshape(-1, 7).numpy())
        assert np.all(err <= bound), float((err - bound).max())


@pytest.mark.parametrize("kind", ["cora", "padded"])
def test_dense_rows_without_tiles_are_zero(kind):
    part, meta = _partition(kind)
    tiles, _, tile_col, b, plan = _stacked(part, meta, 2, 5)
    got = bsr_spmm_rows(*_t(tiles, tile_col),
                        b_tiles_of(torch.from_numpy(b), meta),
                        plan_to(plan, "cpu").dense, device="cpu")
    empty = torch.from_numpy(np.asarray(plan.dense.lengths) == 0).reshape(
        2, -1)
    assert bool(empty.any()) and bool((~empty).any())
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))
    assert bool((got[~empty] != 0).any())


def _no_tiles(g=2, f=5, nrt=3, nct=4, t=64):
    """A dense part with no tile (as a class whose partition puts every
    tile into the ELL engine has), B tiles and the empty stacked plan."""
    b = np.random.default_rng(0).standard_normal(
        (g, nct, t, f)).astype(np.float32)
    plan = stack_plans([tc.ReductionPlan(*[segment_plan(
        np.zeros(0, np.int64), nrt)] * 3)] * g).dense
    return (np.zeros((g, 0, t, t), np.float32), np.zeros((g, 0), np.int32),
            b, plan)


def test_dense_rows_of_a_partition_without_tiles_are_zero():
    tiles, tcol, b, plan = _no_tiles()
    plan = plan_to(tc.ReductionPlan(plan, plan, plan), "cpu").dense
    want = torch.zeros((2, 3, 64, 5))
    assert torch.equal(bsr_spmm_rows_ref(*_t(tiles, tcol, b), plan), want)
    assert torch.equal(bsr_spmm_rows(*_t(tiles, tcol, b), plan,
                                     device="cpu"), want)


@pytest.mark.parametrize("kind", ["cora", "padded"])
def test_segment_offsets_are_cumsum_and_cover_the_order(kind):
    part, meta = _partition(kind)
    g, nrt = 3, meta.n_row_tiles
    n_t = np.asarray(part.dense.tiles).shape[0]
    tile_row = np.asarray(part.dense.tile_row)
    for plan in (stack_plans([reduction_plan(part, meta)] * g).dense,
                 plan_to(stack_plans([reduction_plan(part, meta)] * g),
                         "cpu").dense):
        order, lengths, offsets = (np.asarray(x) for x in (
            plan.order, plan.lengths, plan.offsets))
        assert offsets.dtype == np.int64 and offsets.shape == (g * nrt + 1,)
        np.testing.assert_array_equal(
            offsets, np.concatenate([[0], np.cumsum(lengths)]))
        assert offsets[-1] == order.shape[0]
        for s in range(g * nrt):
            seg = order[offsets[s]:offsets[s + 1]]
            assert np.all(seg // n_t == s // nrt)            # its member
            assert np.all(tile_row[seg % n_t] == s % nrt)    # its row tile
        # every plan entry in exactly one segment
        assert sorted(np.concatenate([order[offsets[s]:offsets[s + 1]]
                                      for s in range(g * nrt)])) == \
            sorted(order)


def test_segment_offsets_are_zero_then_cumsum():
    lengths = np.array([2, 0, 3, 1])
    np.testing.assert_array_equal(segment_offsets(lengths),
                                  np.array([0, 2, 2, 5, 6]))
    assert segment_plan(np.array([3, 0, 0, 2]), 4).offsets.tolist() == \
        [0, 2, 2, 3, 4]


def test_ops_dense_route_is_the_folded_function():
    part, meta = _partition("padded")
    tiles, _, tile_col, b, plan = _stacked(part, meta, 2, 6)
    tp = tc.partition_to(tc.TriPartition(
        tc.DenseTiles(*(np.stack([np.asarray(x)] * 2) for x in part.dense)),
        part.ell, part.coo), "cpu")
    got = ops.dense_tiles_matmul(tp, torch.from_numpy(b), meta,
                                 plan_to(plan, "cpu"))
    want = bsr_spmm_rows_ref(*_t(tiles, tile_col),
                             b_tiles_of(torch.from_numpy(b), meta),
                             plan_to(plan, "cpu").dense)
    assert torch.equal(got, want.reshape(2, -1, 6))


def test_build_key_hashes_the_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build._library_path(tmp_path / "k.cu")
    assert first == _build._library_path(tmp_path / "k.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._library_path(tmp_path / "k.cu") != first
    assert [p.name for p in _build.headers()] == ["h.cuh"]


# ---------------------------------------------------------- on the card ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _random_dense(seed, g, f, n_t=9, nrt=6, nct=5, t=64):
    """Tiles on random row tiles (some rows empty, some with several
    tiles) and their plan, stacked over G members."""
    rng = np.random.default_rng(seed)
    tiles = (rng.standard_normal((g, n_t, t, t))
             * (rng.random((g, n_t, t, t)) < 0.5)).astype(np.float32)
    tcol = rng.integers(0, nct, (g, n_t)).astype(np.int32)
    trow = rng.choice([0, 2, 3, 5], (g, n_t))
    b = rng.standard_normal((g, nct, t, f)).astype(np.float32)
    plan = stack_plans([tc.ReductionPlan(*[segment_plan(trow[i], nrt)] * 3)
                        for i in range(g)]).dense
    return tiles, tcol, b, plan


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("f", [3, 7, 128, 130])
def test_cuda_dense_rows_match_plain(cuda_device, f, g):
    tiles, tcol, b, plan = _random_dense(f + g, g, f)
    args = [x.to(cuda_device) for x in _t(tiles, tcol, b)]
    plan = plan_to(tc.ReductionPlan(plan, plan, plan), cuda_device).dense
    ops.reset_launch_counts()
    got = bsr_spmm_rows(*args, plan)
    scale = bsr_spmm_rows_ref(args[0].abs(), args[1], args[2].abs(), plan)
    err = (got - bsr_spmm_rows_ref(*args, plan)).abs()
    assert bool((err <= KERNEL_TOL["atol"]
                 + KERNEL_TOL["rtol"] * scale).all())
    # the per-tile kernel's products summed by segment_sum: the same bits
    n_t, t = tiles.shape[1], tiles.shape[2]
    per_tile = bsr_spmm(*args)
    summed = segment_sum(per_tile.reshape(g * n_t, t * f), plan)
    assert torch.equal(got, summed.reshape(got.shape))
    empty = (plan.lengths == 0).reshape(g, -1)
    assert bool((got[empty] == 0).all())
    assert ops.launch_counts()["bsr_spmm"] == 2


@pytest.mark.cuda
def test_cuda_dense_engine_one_launch_per_layer(cuda_device):
    a = make_heterogeneous_matrix(300, seed=0)
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    ws = [rng.standard_normal((24, 16)).astype(np.float32),
          rng.standard_normal((16, 5)).astype(np.float32)]
    ops.reset_launch_counts()
    y = tc.gcn_forward(part, x, ws, meta=meta)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bsr_spmm"] == len(ws)
    want = tc.gcn_forward(part, x, ws, meta=meta, backend="torch")
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_dense_rows_without_tiles_are_zero_and_launch_nothing(
        cuda_device):
    tiles, tcol, b, plan = _no_tiles()
    plan = plan_to(tc.ReductionPlan(plan, plan, plan), cuda_device).dense
    ops.reset_launch_counts()
    got = bsr_spmm_rows(*[x.to(cuda_device) for x in _t(tiles, tcol, b)],
                        plan)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), torch.zeros((2, 3, 64, 5)))
    assert ops.launch_counts()["bsr_spmm"] == 0
