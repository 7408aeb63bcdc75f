"""Route TriPartition components through the port's CUDA kernels.

Port of ``repro.kernels.ops``. Each function takes B with a leading
group axis [G, N, F] and returns [G, n_padded_rows, F]; the hand-written
kernels run for the whole group at once (CUDA tensors), or their plain
versions run (CPU tensors). The dense engine's sum onto row tiles runs
inside its kernel. The ELL sum onto output rows, and its add onto the
dense engine's rows, run inside the ELL kernels too: one launch a layer
on every dispatch; and so do the COO engine's sum and its add onto the
dense + ELL rows, inside the COO row kernel. All of them add in the
order of the host-built ``ReductionPlan``.

The module also reads and resets the kernels' launch counters: each
kernel wrapper adds one to its counter where it launches its kernel,
and nowhere else; and the wrappers' call counters (``entry_counts``),
which tick on every device.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import (PartitionMeta, ReductionPlan,
                                      TriPartition, b_tiles_of)

from . import _build
from . import bsr_spmm as _bsr
from . import coo_spmm as _coo
from . import ell_spmm as _ell
from . import tile_matmul as _mm

ELL_DISPATCHES = ("ragged", "fused", "loop")


def launch_counts() -> dict:
    """CUDA kernel launches since the last ``reset_launch_counts``."""
    return {k: sum(c.values()) for k, c in launch_counts_by_dtype().items()}


def launch_counts_by_dtype() -> dict:
    """``launch_counts`` split by the instance's operand types:
    {kernel: {"float32": n, "bfloat16": m}}, "bfloat16" counting every
    instance that reads a bfloat16 operand."""
    with _build.count_lock:
        return {"bsr_spmm": dict(_bsr.launches),
                "ragged_ell_spmm": dict(_ell.launches),
                "ell_spmm": dict(_ell.fixed_k_launches),
                "tile_matmul": dict(_mm.launches),
                "coo_rows": dict(_coo.launches)}


def reset_launch_counts() -> None:
    with _build.count_lock:
        for counts in (_bsr.launches, _ell.launches, _ell.fixed_k_launches,
                       _mm.launches, _coo.launches):
            for k in counts:
                counts[k] = 0


def entry_counts() -> dict:
    """Calls of each kernel wrapper (by name) since the last
    ``reset_entry_counts``, on every device: a CPU tensor's plain
    version counts as its kernel's call."""
    with _build.count_lock:
        return dict(_build.entry_calls)


def reset_entry_counts() -> None:
    with _build.count_lock:
        _build.entry_calls.clear()


def check_ell_dispatch(dispatch: str) -> None:
    if dispatch not in ELL_DISPATCHES:
        raise ValueError(f"unknown ell dispatch {dispatch!r}; choose from "
                         f"{ELL_DISPATCHES}")


def matmul(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """C = A @ B through ``tile_matmul``: the kernel for CUDA tensors,
    its plain version for CPU tensors. ``kw`` is the kernel's block
    configuration knob (``config``)."""
    return _mm.tile_matmul(a, b, device=a.device, **kw)


def dense_tiles_of(part: TriPartition, b: torch.Tensor) -> torch.Tensor:
    """The dense tiles in B's type, as the reference's dense engine casts
    them before its product (``tiles.astype(b.dtype)``): the tiles
    themselves where both are float32."""
    return part.dense.tiles.to(b.dtype)


def dense_tiles_matmul(part: TriPartition, b: torch.Tensor,
                       meta: PartitionMeta, plan: ReductionPlan
                       ) -> torch.Tensor:
    """Dense-engine partial product, [G, n_padded_rows, F] float32: one
    BSR kernel launch that also sums the products over ``tile_row``, in
    the order of ``plan.dense`` (+0 rows and no launch for a class
    without dense tiles), on the tiles in B's type; with a bfloat16 B
    the rows come out rounded to bfloat16 (``bsr_spmm_rows``)."""
    g, _, f = b.shape
    T, nrt = meta.tile, meta.n_row_tiles
    out = _bsr.bsr_spmm_rows(dense_tiles_of(part, b), part.dense.tile_col,
                             b_tiles_of(b, meta), plan.dense,
                             device=b.device)
    return out.reshape(g, nrt * T, f)


def ell_matmul(part: TriPartition, b: torch.Tensor, meta: PartitionMeta,
               plan: ReductionPlan, yd: torch.Tensor, *,
               dispatch: str = "ragged", ell_tune: dict = None
               ) -> torch.Tensor:
    """Sparse-engine partial product added onto the dense engine's rows
    ``yd`` [G, n_padded_rows, F] in place; returns ``yd``. The dense
    engine never writes -0, so a row the ELL part does not reach keeps
    its bits (``yd + 0``).

    ``"ragged"`` makes ONE ``ragged_ell_rows`` launch over the
    concatenated unit array of the whole group: the products, each unit
    to the K of its band of ``meta.ell_segments`` (as the reference's
    ``ops.ell_matmul`` passes ``segments=meta.ell_segments``), their sum
    onto rows and the add onto ``yd``, in the launch shape and band cap
    ``ell_tune`` (an autotuned config; its ``max_bands`` merges the
    runs, as the reference's ``ops.ell_matmul`` passes
    ``ell_tune["max_bands"]``; None = the defaults; the same bits either
    way on finite B).
    ``"fused"``/``"loop"`` are the per-K A/B dispatches: ONE
    ``ell_spmm_rows`` launch for every bucket of ``meta.ell_segments`` and
    the whole group, each unit to its bucket's K (``plan.ell_bucket_k``),
    the products summed onto rows in the order of ``plan.ell`` (bucket
    after bucket, each in unit order) and added onto ``yd``. The
    reference's two scatter structures (one reduction of all buckets'
    products, or one per bucket into a running buffer) add in that one
    order, so both names run this same launch.
    """
    check_ell_dispatch(dispatch)
    if part.ell.cols.shape[-3] == 0:
        return yd
    bt = b_tiles_of(b, meta)
    if dispatch == "ragged":
        return _ell.ragged_ell_rows(part.ell.cols, part.ell.vals,
                                    part.ell.tile_col, part.ell.unit_k, bt,
                                    plan.ell, yd,
                                    segments=tuple(meta.ell_segments),
                                    max_bands=(ell_tune or {}).get(
                                        "max_bands", _ell.DEFAULT_MAX_BANDS),
                                    tune=ell_tune, device=b.device)
    if plan.ell_bucket_k is None:
        raise ValueError("the plan has no bucket table (ell_bucket_k): "
                         "build it with reduction_plan")
    return _ell.ell_spmm_rows(part.ell.cols, part.ell.vals,
                              part.ell.tile_col, bt, plan.ell, yd,
                              plan.ell_bucket_k, device=b.device)


def coo_matmul(part: TriPartition, b: torch.Tensor, meta: PartitionMeta,
               plan: ReductionPlan, y: torch.Tensor) -> torch.Tensor:
    """Flexible-engine partial product added onto the dense + ELL rows
    ``y`` [G, n_padded_rows, F] in place; returns ``y``: ONE
    ``coo_rows`` launch for the whole group, each row's messages summed
    from +0 in the order of ``plan.coo`` (walked in the order of
    ``plan.coo_rows``) and added onto ``y``. That is
    ``y + hybrid_spmm.coo_matmul(...)`` bit for bit: a row without an
    entry keeps its bits, since the dense and ELL engines never write -0
    (``ell_matmul``). No COO entry: ``y`` itself, no launch."""
    if part.coo.vals.shape[-1] == 0:
        return y
    return _coo.coo_rows(part.coo.cols, part.coo.vals, b_tiles_of(b, meta),
                         plan.coo, plan.coo_rows, y, device=b.device)


def dense_heads_matmul(part: TriPartition, coef: torch.Tensor,
                       b: torch.Tensor, meta: PartitionMeta,
                       plan: ReductionPlan) -> torch.Tensor:
    """The dense engine with multi-head values ``coef`` [G, n_t, H, T, T]
    (``gat_coef.gat_edge_coef``) in place of the tiles: column block h of
    B times head h's tile, [G, n_padded_rows, F] float32, one launch."""
    g, _, f = b.shape
    out = _bsr.bsr_spmm_rows_heads(coef, part.dense.tile_col,
                                   b_tiles_of(b, meta), plan.dense,
                                   device=b.device)
    return out.reshape(g, meta.n_row_tiles * meta.tile, f)


def ell_heads_matmul(part: TriPartition, coef: torch.Tensor,
                     b: torch.Tensor, meta: PartitionMeta,
                     plan: ReductionPlan, yd: torch.Tensor) -> torch.Tensor:
    """``ell_matmul`` ("ragged") with multi-head values ``coef``
    [G, U, R, Kmax, H] in place of the units' values, added onto ``yd``
    in place; one launch."""
    if part.ell.cols.shape[-3] == 0:
        return yd
    return _ell.ragged_ell_rows_heads(
        part.ell.cols, coef, part.ell.tile_col, part.ell.unit_k,
        b_tiles_of(b, meta), plan.ell, yd,
        segments=tuple(meta.ell_segments), device=b.device)


def coo_heads_matmul(part: TriPartition, coef: torch.Tensor,
                     b: torch.Tensor, meta: PartitionMeta,
                     plan: ReductionPlan, y: torch.Tensor) -> torch.Tensor:
    """``coo_matmul`` with multi-head values ``coef`` [G, nnz, H] in place
    of the entries' values, added onto ``y`` in place; one launch."""
    if part.coo.vals.shape[-1] == 0:
        return y
    return _coo.coo_rows(part.coo.cols, coef, b_tiles_of(b, meta), plan.coo,
                         plan.coo_rows, y, device=b.device)
