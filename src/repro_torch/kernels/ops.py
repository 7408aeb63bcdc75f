"""Route TriPartition components through the port's CUDA kernels.

Port of ``repro.kernels.ops``. Each function takes B with a leading
group axis [G, N, F] and returns [G, n_padded_rows, F]; the hand-written
kernels run for the whole group at once (CUDA tensors), or their plain
versions run (CPU tensors). The dense engine's sum onto row tiles runs
inside its kernel. The ELL sum onto output rows, and its add onto the
dense engine's rows, run inside the ELL kernels too: in one launch on
the "ragged" dispatch, in one launch per class band on the
"fused"/"loop" dispatches. All of them add in the order of the
host-built ``ReductionPlan``.

The module also reads and resets the kernels' launch counters: each
kernel wrapper adds one to its counter where it launches its kernel,
and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import (PartitionMeta, ReductionPlan,
                                      TriPartition, b_tiles_of, ell_buckets)

from . import _build
from . import bsr_spmm as _bsr
from . import ell_spmm as _ell
from . import tile_matmul as _mm

ELL_DISPATCHES = ("ragged", "fused", "loop")


def launch_counts() -> dict:
    """CUDA kernel launches since the last ``reset_launch_counts``."""
    with _build.count_lock:
        return {"bsr_spmm": _bsr.launches, "ragged_ell_spmm": _ell.launches,
                "ell_spmm": _ell.fixed_k_launches,
                "tile_matmul": _mm.launches}


def reset_launch_counts() -> None:
    with _build.count_lock:
        _bsr.launches = 0
        _ell.launches = 0
        _ell.fixed_k_launches = 0
        _mm.launches = 0


def check_ell_dispatch(dispatch: str) -> None:
    if dispatch not in ELL_DISPATCHES:
        raise ValueError(f"unknown ell dispatch {dispatch!r}; choose from "
                         f"{ELL_DISPATCHES}")


def matmul(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """C = A @ B through ``tile_matmul``: the kernel for CUDA tensors,
    its plain version for CPU tensors. ``kw`` is the kernel's block
    configuration knob (``config``)."""
    return _mm.tile_matmul(a, b, device=a.device, **kw)


def dense_tiles_matmul(part: TriPartition, b: torch.Tensor,
                       meta: PartitionMeta, plan: ReductionPlan
                       ) -> torch.Tensor:
    """Dense-engine partial product, [G, n_padded_rows, F]: one BSR
    kernel launch that also sums the products over ``tile_row``, in the
    order of ``plan.dense`` (+0 rows and no launch for a class without
    dense tiles)."""
    g, _, f = b.shape
    T, nrt = meta.tile, meta.n_row_tiles
    out = _bsr.bsr_spmm_rows(part.dense.tiles, part.dense.tile_col,
                             b_tiles_of(b, meta), plan.dense,
                             device=b.device)
    return out.reshape(g, nrt * T, f)


def ell_matmul(part: TriPartition, b: torch.Tensor, meta: PartitionMeta,
               plan: ReductionPlan, yd: torch.Tensor, *,
               dispatch: str = "ragged") -> torch.Tensor:
    """Sparse-engine partial product added onto the dense engine's rows
    ``yd`` [G, n_padded_rows, F] in place; returns ``yd``. The dense
    engine never writes -0, so a row the ELL part does not reach keeps
    its bits (``yd + 0``).

    ``"ragged"`` makes ONE ``ragged_ell_rows`` launch over the
    concatenated unit array of the whole group: the products, their sum
    onto rows and the add onto ``yd``.
    ``"fused"``/``"loop"`` are the per-K A/B dispatches: one
    ``ell_spmm_rows`` launch per bucket (class band) of
    ``meta.ell_segments`` for the whole group, each doing its band's
    products, their sum onto rows and the add onto ``yd``, in the bands'
    ``plan.ell_bands``. The reference's two scatter structures (one
    reduction of all buckets' products, or one per bucket into a running
    buffer) add in one order, so both names run these same launches.
    """
    check_ell_dispatch(dispatch)
    f = b.shape[-1]
    if part.ell.cols.shape[-3] == 0:
        return yd
    bt = b_tiles_of(b, meta)
    if dispatch == "ragged":
        return _ell.ragged_ell_rows(part.ell.cols, part.ell.vals,
                                    part.ell.tile_col, part.ell.unit_k, bt,
                                    plan.ell, yd, device=b.device)
    buckets = ell_buckets(part.ell, meta.ell_segments)
    if len(plan.ell_bands) != len(buckets):
        raise ValueError(f"{len(plan.ell_bands)} band plans for "
                         f"{len(buckets)} buckets (build the plan with "
                         "reduction_plan)")
    n_carry = plan.ell_bands[0].n_carry
    carry = (yd.new_empty((yd.shape[0], n_carry, f)) if n_carry else None)
    for bucket, band in zip(buckets, plan.ell_bands):
        _ell.ell_spmm_rows(bucket.cols, bucket.vals, bucket.tile_col, bt,
                           band, yd, carry, device=b.device)
    return yd
