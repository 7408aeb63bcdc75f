"""The kernels' bfloat16 instances, and their checks of input types.

The reference's four TPU kernels take float32 or bfloat16 operands with a
float32 accumulator; so do the port's. On the CPU the wrappers run their
plain versions for both types (held against the reference in
``tests/test_torch_bf16.py``) and refuse any other type. Tests marked
``cuda`` launch the bfloat16 instances on the card:

  * the ELL kernels widen a bfloat16 ``vals`` or B where they load it and
    run the float32 chain, so each bfloat16 instance must be
    ``torch.equal`` to the float32 instance fed ``vals.float()`` and
    ``b.float()``, in every launch shape the ragged kernel is built with,
    and to its plain version;
  * ``bsr_spmm`` and ``tile_matmul`` multiply on the tensor cores, which
    sum each k16 step in their own order: they are held to
    ``|got - want| <= ulp_bf16(|want|) + 2e-6 * (|A| @ |B|)`` (one
    bfloat16 rounding of the result, plus float32 sums of the exact
    products taken in another order, ``ref.bf16_tolerance``), with the
    product of absolute values in float64; and must repeat bit for bit,
    across configurations and group sizes. ``hybrid_spmm`` rounds the
    dense engine's rows on the way, so against the plain backend it has
    ``ulp_bf16(|A| @ |B|)`` more.

This file imports no JAX, so that it runs on a machine with a card.
"""
import itertools

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.formats import (_segments_to, b_tiles_of,
                                      segment_plan, segment_sum)
from repro_torch.core.hybrid_spmm import _grouped
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_rows
from repro_torch.kernels.ell_spmm import (TUNE_KC, TUNE_THREADS, TUNE_VEC,
                                          TUNE_W, ell_spmm, ragged_ell_spmm)
from repro_torch.kernels.ref import (_gather_b_tiles, bf16_tolerance,
                                     bsr_spmm_ref, bsr_spmm_rows_ref,
                                     ell_spmm_ref, ragged_ell_spmm_ref,
                                     tile_matmul_ref)
from repro_torch.kernels.tile_matmul import CONFIGS, tile_matmul

from conftest import make_heterogeneous_matrix
from test_torch_kernels import _t, bsr_inputs, ell_inputs

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
# (vals, B) type pairs of the ELL kernels' bfloat16 instances
ELL_PAIRS = [(F32, BF16), (BF16, BF16), (BF16, F32)]
TUNES = [dict(zip(("w", "vec", "kc", "threads"), c)) for c in
         itertools.product(TUNE_W, TUNE_VEC, TUNE_KC, TUNE_THREADS)]


def within(got, want, mag, rounded=None) -> bool:
    if rounded is not None:
        rounded = rounded.to(want.device)
    return bool(((got.double() - want.double()).abs()
                 <= bf16_tolerance(want, mag.to(want.device),
                                   rounded=rounded)).all())


def abs_product(a, b):
    """|A| @ |B| in float64 on the host (2-D or batched)."""
    return torch.from_numpy(np.abs(a.double().cpu().numpy())
                            @ np.abs(b.double().cpu().numpy()))


# ---------------------------------------------------------- on the CPU ----
def test_bf16_tolerance_is_one_rounding_plus_the_sum_order():
    want = torch.tensor([1.0, 3.0, 0.0, -256.0])
    mag = torch.tensor([1.0, 0.0, 1.0, 0.0], dtype=torch.float64)
    bound = bf16_tolerance(want, mag)
    torch.testing.assert_close(bound, torch.tensor(
        [2.0 ** -7 + 2e-6, 2.0 ** -6, 2e-6, 2.0], dtype=torch.float64))


def test_instance_names_are_the_ones_ptxas_prints():
    """The contracts' ptxas names, as the card's build log prints them
    (a repeated class type is a substitution)."""
    from repro_torch.kernels._build import mangled_args
    from repro_torch.kernels.ell_spmm import ell_contract, ragged_ell_contract
    assert mangled_args((32, 4, "float32", "float32")) == "ILi32ELi4EffE"
    assert ell_contract(1, 4, 8, 3, 2, 64, 128, vals_dtype=BF16,
                        b_dtype=BF16)["ptxas_name"] == (
        "ell_band_kernelILi32ELi4E13__nv_bfloat16S1_E")
    c = ragged_ell_contract(1, 4, 8, 3, 2, 64, 8, vals_dtype=BF16)
    assert c["ptxas_name"] == (
        "ell_rows_kernelILi8ELi1ELi4ELi256E13__nv_bfloat16fE")
    assert c["source"] == "ragged_ell_spmm_bf16_f32"


def test_wrappers_refuse_other_types():
    tiles, tcol, b = _t(*bsr_inputs(0))
    with pytest.raises(ValueError, match="bfloat16"):
        bsr_spmm(tiles.half(), tcol, b.half(), device="cpu")
    with pytest.raises(ValueError, match="one type"):
        bsr_spmm(tiles.to(BF16), tcol, b, device="cpu")
    cols, vals, tc_, uk, bb = _t(*ell_inputs(0))
    with pytest.raises(ValueError, match="bfloat16"):
        ragged_ell_spmm(cols, vals, tc_, uk, bb.half(), device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        ell_spmm(cols, vals.double(), tc_, bb, device="cpu")
    a = torch.ones(4, 4)
    # the plain version computes any type; the kernel refuses on the card
    assert tile_matmul(a.to(BF16), a.to(BF16), device="cpu").dtype == BF16


@pytest.mark.parametrize("vt,bt", ELL_PAIRS)
def test_plain_ell_bf16_is_the_f32_version_on_upcast_values(vt, bt):
    cols, vals, tcol, uk, b = _t(*ell_inputs(3, f=9))
    vals, b = vals.to(vt), b.to(bt)
    got = ragged_ell_spmm(cols, vals, tcol, uk, b, device="cpu")
    assert got.dtype == F32
    assert torch.equal(got, ragged_ell_spmm(cols, vals.float(), tcol, uk,
                                            b.float(), device="cpu"))
    got = ell_spmm(cols, vals, tcol, b, device="cpu")
    assert torch.equal(got, ell_spmm(cols, vals.float(), tcol, b.float(),
                                     device="cpu"))


def test_plain_dense_rows_round_to_bf16():
    tiles, tcol, b = (x.to(BF16) if x.is_floating_point() else x
                      for x in _t(*bsr_inputs(1, g=2)))
    plan = _segments_to(segment_plan(
        np.array([0, 1, 0, 1, 1, 2, 3, 2, 3, 3]), 4), "cpu")
    rows = bsr_spmm_rows(tiles, tcol, b, plan, device="cpu")
    sums = segment_sum(bsr_spmm(tiles, tcol, b, device="cpu").reshape(
        10, -1), plan).reshape(rows.shape)
    assert rows.dtype == F32
    assert torch.equal(rows, sums.to(BF16).float())
    assert not torch.equal(sums, sums.to(BF16).float())


# ---------------------------------------------------------- on the card ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("vt,bt", ELL_PAIRS)
@pytest.mark.parametrize("f,g", [(7, None), (128, None), (130, 4)])
def test_cuda_ragged_bf16_equals_f32_on_upcast(cuda_device, vt, bt, f, g):
    cols, vals, tcol, uk, b = (a.to(cuda_device) for a in _t(*ell_inputs(
        6, t=64, f=f, g=g)))
    vals, b = vals.to(vt), b.to(bt)
    ops.reset_launch_counts()
    for tune in TUNES:
        got = ragged_ell_spmm(cols, vals, tcol, uk, b, tune=tune)
        want = ragged_ell_spmm(cols, vals.float(), tcol, uk, b.float(),
                               tune=tune)
        assert torch.equal(got, want), tune
    assert torch.equal(got, ragged_ell_spmm_ref(cols, vals, tcol, uk, b))
    counts = ops.launch_counts_by_dtype()["ragged_ell_spmm"]
    assert counts == {"float32": len(TUNES), "bfloat16": len(TUNES)}


@pytest.mark.cuda
@pytest.mark.parametrize("vt,bt", ELL_PAIRS)
@pytest.mark.parametrize("f,g", [(7, None), (128, None), (130, 4)])
def test_cuda_fixed_k_bf16_equals_f32_on_upcast(cuda_device, vt, bt, f, g):
    cols, vals, tcol, _, b = (a.to(cuda_device) for a in _t(*ell_inputs(
        7, t=64, f=f, g=g, kmax=9)))
    vals, b = vals.to(vt), b.to(bt)
    got = ell_spmm(cols[..., :5], vals[..., :5], tcol, b)   # strided view
    assert torch.equal(got, ell_spmm(cols[..., :5], vals.float()[..., :5],
                                     tcol, b.float()))
    assert torch.equal(got, ell_spmm_ref(cols[..., :5], vals[..., :5], tcol,
                                         b))


def _hetero(dev, f, seed=0):
    a = make_heterogeneous_matrix(300, seed=0)
    part, meta, _ = tc.analyze_and_partition(tc.csr_from_dense(a),
                                             tc.PartitionConfig(tile=64))
    b = np.random.default_rng(seed).standard_normal((300, f)).astype(
        np.float32)
    return a, part, meta, b


@pytest.mark.cuda
@pytest.mark.parametrize("vt", [F32, BF16])
@pytest.mark.parametrize("dispatch", ["ragged", "fused", "loop"])
def test_cuda_ell_rows_bf16_equal_f32_on_upcast(cuda_device, vt, dispatch):
    """The ELL row kernels (the sum onto rows and the add onto the dense
    rows inside the kernel) at bfloat16 B, every tuned launch shape of the
    ragged kernel."""
    _, part, meta, b = _hetero(cuda_device, 16)
    p, bb, plan, _ = _grouped(part, torch.from_numpy(b).to(BF16), None,
                              meta, cuda_device)
    p = p._replace(ell=p.ell._replace(vals=p.ell.vals.to(vt)))
    yd = torch.randn((1, meta.n_padded_rows, 16), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(0))
    for tune in (TUNES if dispatch == "ragged" else [None]):
        got = ops.ell_matmul(p, bb, meta, plan, yd.clone(),
                             dispatch=dispatch, ell_tune=tune)
        pf = p._replace(ell=p.ell._replace(vals=p.ell.vals.float()))
        want = ops.ell_matmul(pf, bb.float(), meta, plan, yd.clone(),
                              dispatch=dispatch, ell_tune=tune)
        assert torch.equal(got, want), tune


@pytest.mark.cuda
@pytest.mark.parametrize("f,g", [(7, None), (16, None), (128, None),
                                 (130, 4)])
def test_cuda_bsr_bf16_within_bound_and_bitwise(cuda_device, f, g):
    tiles, tcol, b = (a.to(cuda_device) for a in _t(*bsr_inputs(
        5, t=64, f=f, g=g)))
    tiles, b = tiles.to(BF16), b.to(BF16)
    got = bsr_spmm(tiles, tcol, b)
    assert got.dtype == F32
    want = bsr_spmm_ref(tiles, tcol, b)
    grouped = (tiles, tcol, b) if g else (tiles[None], tcol[None], b[None])
    mag = abs_product(grouped[0], _gather_b_tiles(grouped[2], grouped[1]))
    assert within(got, want, mag.reshape(got.shape))
    assert torch.equal(bsr_spmm(tiles, tcol, b), got)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [7, 16, 128])
def test_cuda_bsr_rows_bf16(cuda_device, f):
    """The dense engine's rows at bfloat16: within one bfloat16 rounding
    (plus the float32 sum order) of the plain version, equal to the
    per-tile kernel's products summed by ``segment_sum`` and then rounded,
    and the same bits for a member alone and in a group of 4."""
    a, part, meta, b = _hetero(cuda_device, f)
    bt = torch.from_numpy(b).to(BF16)
    p, bb, plan, _ = _grouped(part, bt, None, meta, cuda_device)
    tiles = ops.dense_tiles_of(p, bb)
    bts = b_tiles_of(bb, meta)
    rows = bsr_spmm_rows(tiles, p.dense.tile_col, bts, plan.dense)
    want = bsr_spmm_rows_ref(tiles, p.dense.tile_col, bts, plan.dense)
    per_tile_mag = abs_product(tiles, _gather_b_tiles(bts, p.dense.tile_col))
    g, n_t, t, _ = tiles.shape
    mag = segment_sum(per_tile_mag.reshape(g * n_t, -1).to(cuda_device),
                      plan.dense).reshape(rows.shape)
    assert within(rows, want, mag)
    per_tile = bsr_spmm(tiles, p.dense.tile_col, bts)
    folded = segment_sum(per_tile.reshape(g * n_t, -1), plan.dense)
    assert torch.equal(rows, folded.reshape(rows.shape).to(BF16).float())
    y1 = tc.hybrid_spmm(part, bt, meta=meta)
    y4 = tc.hybrid_spmm(
        tc.TriPartition(*(type(c)(*(np.stack([np.asarray(x)] * 4) for x in c))
                          for c in part)), bt[None].expand(4, -1, -1),
        meta=meta)
    assert all(torch.equal(y4[i], y1) for i in range(4))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [8, 128])
def test_cuda_hybrid_bf16_against_the_plain_backend(cuda_device, f):
    a, part, meta, b = _hetero(cuda_device, f)
    bt = torch.from_numpy(b).to(BF16)
    ys = {}
    ops.reset_launch_counts()
    for d in ("ragged", "fused", "loop"):
        ys[d] = tc.hybrid_spmm(part, bt, meta=meta, ell_dispatch=d)
        assert ys[d].dtype == BF16
        assert torch.equal(ys[d], ys["ragged"])
        assert torch.equal(tc.hybrid_spmm(part, bt, meta=meta,
                                          ell_dispatch=d), ys[d])
    counts = ops.launch_counts_by_dtype()
    assert counts["bsr_spmm"]["bfloat16"] == 6
    assert counts["ragged_ell_spmm"] == {"float32": 0, "bfloat16": 2}
    plain = tc.hybrid_spmm(part, bt, meta=meta, backend="torch")
    mag = abs_product(torch.from_numpy(a), bt.float())
    # the dense engine's rows are rounded to bfloat16 on the way too
    assert within(ys["ragged"].cpu(), plain.cpu(), mag, rounded=mag)


def _bf16_view(x: np.ndarray, off: int, device):
    """``x`` in bfloat16 on ``device`` as a contiguous view that starts
    ``off`` elements into a larger buffer (not 16-byte aligned unless
    ``off`` is a multiple of 8)."""
    buf = torch.zeros(x.size + off + 8, dtype=BF16, device=device)
    view = buf[off:off + x.size].view(x.shape)
    view.copy_(torch.from_numpy(np.ascontiguousarray(x)).to(BF16))
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,off", [
    (1, 128, 128, (0, 0, 0)), (8, 8, 8, (0, 0, 0)), (70, 33, 5, (0, 0, 0)),
    (257, 300, 130, (0, 0, 0)), (4096, 1433, 128, (0, 0, 0)),
    (4096, 3703, 128, (0, 0, 0)), (32768, 500, 128, (0, 0, 0)),
    (4096, 128, 7, (0, 0, 0)),
    # K = 1, 3, 5 and 7 (mod 8): every row of A starts at another shift
    (257, 1025, 128, (0, 0, 0)), (257, 1027, 128, (0, 0, 0)),
    (257, 1029, 128, (0, 0, 0)), (257, 1031, 128, (0, 0, 0)),
    # A, B and C 1, 3 and 7 elements into larger buffers
    (300, 1433, 128, (1, 3, 7)), (300, 1433, 128, (3, 7, 1)),
    (300, 1433, 128, (7, 1, 3)), (300, 128, 7, (1, 3, 7)),
    (130, 3703, 136, (3, 1, 7)),
    # M not a multiple of any tile's rows
    (4099, 500, 128, (0, 0, 0)), (4161, 1433, 130, (0, 0, 0)),
    (33, 64, 3, (0, 0, 0)),
    # N = 3, 6 and 7 (the graphs' layer 2)
    (4096, 128, 6, (0, 0, 0)), (32768, 128, 3, (0, 0, 0)),
    (1000, 131, 7, (1, 7, 3))])
def test_cuda_tile_matmul_bf16(cuda_device, m, k, n, off):
    rng = np.random.default_rng(m + k)
    a = _bf16_view(rng.standard_normal((m, k)).astype(np.float32), off[0],
                   cuda_device)
    b = _bf16_view(rng.standard_normal((k, n)).astype(np.float32), off[1],
                   cuda_device)
    ops.reset_launch_counts()
    outs = [tile_matmul(a, b, config=c, out=_bf16_view(
        np.zeros((m, n), np.float32), off[2], cuda_device)) for c in CONFIGS]
    assert outs[0].dtype == BF16
    # one accumulator per element and split over the k16 steps, the splits
    # added in rank order: every configuration gives the same bits, and so
    # does a repeat
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert torch.equal(tile_matmul(a, b), outs[0])
    assert within(outs[0].float(), tile_matmul_ref(a, b).float(),
                  abs_product(a, b))
    assert ops.launch_counts_by_dtype()["tile_matmul"] == {
        "float32": 0, "bfloat16": len(CONFIGS) + 1}
