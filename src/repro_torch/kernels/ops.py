"""Route TriPartition components through the port's CUDA kernels.

Port of ``repro.kernels.ops``. Each function takes B with a leading
group axis [G, N, F] and returns [G, n_padded_rows, F]; the hand-written
kernels run for the whole group at once (CUDA tensors), or their plain
versions run (CPU tensors). The reductions onto output rows are the
deterministic segment sums of ``repro_torch.core.formats``.

The module also reads and resets the kernels' launch counters: each
kernel wrapper adds one to its counter where it launches its kernel,
and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import (PartitionMeta, ReductionPlan,
                                      TriPartition, b_tiles_of, ell_buckets,
                                      scatter_ell_partials, segment_sum)

from . import bsr_spmm as _bsr
from . import ell_spmm as _ell
from . import tile_matmul as _mm

ELL_DISPATCHES = ("ragged", "fused", "loop")


def launch_counts() -> dict:
    """CUDA kernel launches since the last ``reset_launch_counts``."""
    return {"bsr_spmm": _bsr.launches, "ragged_ell_spmm": _ell.launches,
            "ell_spmm": _ell.fixed_k_launches, "tile_matmul": _mm.launches}


def reset_launch_counts() -> None:
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
    width knob (``bn``)."""
    return _mm.tile_matmul(a, b, device=a.device, **kw)


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
    """Sparse-engine partial product, [G, n_padded_rows, F].

    ``"ragged"`` makes ONE ``ragged_ell_spmm`` launch over the
    concatenated unit array of the whole group. ``"fused"``/``"loop"``
    are the per-K A/B dispatches: one ``ell_spmm`` launch per bucket of
    ``meta.ell_segments`` for the whole group, each writing its unit
    slice of one product buffer; "fused" reduces the buffer once,
    "loop" bucket by bucket into a running buffer.
    """
    check_ell_dispatch(dispatch)
    g, _, f = b.shape
    u, r = part.ell.cols.shape[-3], part.ell.cols.shape[-2]
    if u == 0:
        return b.new_zeros((g, meta.n_padded_rows, f))
    bt = b_tiles_of(b, meta)
    if dispatch == "ragged":
        prod = _ell.ragged_ell_spmm(part.ell.cols, part.ell.vals,
                                    part.ell.tile_col, part.ell.unit_k, bt,
                                    device=b.device)
    else:
        prod = torch.empty((g, u, r, f), dtype=torch.float32,
                           device=b.device)
        at = 0
        for bucket in ell_buckets(part.ell, meta.ell_segments):
            n = bucket.cols.shape[-3]
            _ell.ell_spmm(bucket.cols, bucket.vals, bucket.tile_col, bt,
                          out=prod[:, at:at + n], device=b.device)
            at += n
    return reduce_ell(part, prod, meta, plan, dispatch)


def reduce_ell(part: TriPartition, prod: torch.Tensor, meta: PartitionMeta,
               plan: ReductionPlan, dispatch: str) -> torch.Tensor:
    """Sum the per-unit products ``prod`` [G, U, R, F] onto padded rows:
    at once ("ragged", "fused") or bucket by bucket ("loop")."""
    g, u, r, f = prod.shape
    if dispatch != "loop":
        return scatter_ell_partials(part.ell.rows.reshape(g, u * r),
                                    prod.reshape(g, u * r, f), meta,
                                    plan=plan.ell)
    buckets = ell_buckets(part.ell, meta.ell_segments)
    rows, partials, at = [], [], 0
    for bucket in buckets:
        n = bucket.rows.shape[-2]
        rows.append(bucket.rows.reshape(g, n * r))
        partials.append(prod[:, at:at + n].reshape(g, n * r, f))
        at += n
    return scatter_ell_partials(rows, partials, meta,
                                plan=plan.ell_buckets)
