"""Route TriPartition components through the port's CUDA kernels.

Port of ``repro.kernels.ops``. Each function takes B with a leading
group axis [G, N, F] and returns [G, n_padded_rows, F]; the hand-written
kernels run once per call for the whole group (CUDA tensors), or their
plain versions run (CPU tensors). The reductions onto output rows are
the deterministic segment sums of ``repro_torch.core.formats``.

The module also reads and resets the kernels' launch counters: each
kernel wrapper adds one to its counter where it launches its kernel,
and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import (PartitionMeta, ReductionPlan,
                                      TriPartition, b_tiles_of,
                                      scatter_ell_partials, segment_sum)

from . import bsr_spmm as _bsr
from . import ell_spmm as _ell


def launch_counts() -> dict:
    """CUDA kernel launches since the last ``reset_launch_counts``."""
    return {"bsr_spmm": _bsr.launches, "ragged_ell_spmm": _ell.launches}


def reset_launch_counts() -> None:
    _bsr.launches = 0
    _ell.launches = 0


def dense_tiles_matmul(part: TriPartition, b: torch.Tensor,
                       meta: PartitionMeta, plan: ReductionPlan
                       ) -> torch.Tensor:
    """Dense-engine partial product through the BSR kernel."""
    g, _, f = b.shape
    T, nrt = meta.tile, meta.n_row_tiles
    n_t = part.dense.tiles.shape[-3]
    if n_t == 0:
        return b.new_zeros((g, nrt * T, f))
    prod = _bsr.bsr_spmm(part.dense.tiles, part.dense.tile_col,
                         b_tiles_of(b, meta), device=b.device)
    out = segment_sum(prod.reshape(g * n_t, T * f), plan.dense)
    return out.reshape(g, nrt * T, f)


def ell_matmul(part: TriPartition, b: torch.Tensor, meta: PartitionMeta,
               plan: ReductionPlan, *, dispatch: str = "ragged"
               ) -> torch.Tensor:
    """Sparse-engine partial product: ONE ``ragged_ell_spmm`` launch over
    the concatenated unit array of the whole group.

    Only ``dispatch="ragged"`` is ported; the reference's legacy
    per-K-launch "fused"/"loop" A/B dispatches come with the fixed-K
    kernel in a later PR of the port.
    """
    if dispatch != "ragged":
        raise ValueError(
            f"ell dispatch {dispatch!r} is not ported yet: only 'ragged' "
            "runs here ('fused'/'loop' need the fixed-K ell_spmm kernel, "
            "which a later PR of the port brings)")
    g, _, f = b.shape
    u, r = part.ell.cols.shape[-3], part.ell.cols.shape[-2]
    if u == 0:
        return b.new_zeros((g, meta.n_padded_rows, f))
    prod = _ell.ragged_ell_spmm(part.ell.cols, part.ell.vals,
                                part.ell.tile_col, part.ell.unit_k,
                                b_tiles_of(b, meta), device=b.device)
    return scatter_ell_partials(part.ell.rows.reshape(g, u * r),
                                prod.reshape(g, u * r, f), meta,
                                plan=plan.ell)
