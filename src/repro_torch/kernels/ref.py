"""Plain PyTorch versions of the port's hand-written kernels.

Port of ``repro.kernels.ref``. They are what the kernel wrappers run
for CPU tensors, what the "torch" backend of
``repro_torch.core.hybrid_spmm`` runs on any device, and what the
kernels are held against on the card.

The sparse ones accept an optional leading group axis ``G`` on every
argument; ``tile_matmul_ref`` is two-dimensional, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import SegmentPlan, segment_sum
from repro_torch.device import pin_ieee_f32


def tile_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with a float32 accumulator, in A's dtype. TF32 is
    switched off first, so a float32 product on the card is full IEEE
    float32."""
    pin_ieee_f32()
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _gather_b_tiles(b_tiles: torch.Tensor, tile_col: torch.Tensor):
    """b_tiles [G, nct, T, F], tile_col [G, n] -> [G, n, T, F]."""
    g = torch.arange(b_tiles.shape[0], device=b_tiles.device)[:, None]
    return b_tiles[g, tile_col.long()]


def bsr_spmm_ref(tiles: torch.Tensor, tile_col: torch.Tensor,
                 b_tiles: torch.Tensor) -> torch.Tensor:
    """Per-tile products of a BSR stack against tile-sliced B.

    tiles [(G,) n_t, T, T], tile_col [(G,) n_t], b_tiles [(G,) nct, T, F]
    returns [(G,) n_t, T, F] float32 (the caller sums over tile_row).
    """
    grouped = tiles.dim() == 4
    if not grouped:
        tiles, tile_col, b_tiles = tiles[None], tile_col[None], b_tiles[None]
    out = torch.matmul(tiles, _gather_b_tiles(b_tiles, tile_col))
    return out if grouped else out[0]


def bsr_spmm_rows_ref(tiles: torch.Tensor, tile_col: torch.Tensor,
                      b_tiles: torch.Tensor, plan: SegmentPlan
                      ) -> torch.Tensor:
    """The dense engine: per-tile products summed per row tile.

    tiles [G, n_t, T, T], tile_col [G, n_t], b_tiles [G, nct, T, F] and
    ``plan`` (a ``SegmentPlan`` over the G * n_t tiles onto G * n_rt row
    tiles) -> [G, n_rt, T, F] float32: ``bsr_spmm_ref`` followed by
    ``segment_sum`` over the plan, in its order. Row tiles without a tile
    are 0.
    """
    g, n_t, t, _ = tiles.shape
    f = b_tiles.shape[-1]
    prod = bsr_spmm_ref(tiles, tile_col, b_tiles)
    out = segment_sum(prod.reshape(g * n_t, t * f), plan)
    return out.reshape(g, -1, t, f)


def ell_spmm_ref(cols: torch.Tensor, vals: torch.Tensor,
                 tile_col: torch.Tensor, b_tiles: torch.Tensor
                 ) -> torch.Tensor:
    """Per-unit ELL products of one fixed-K bucket.

    cols [(G,) U, R, K] tile-local, vals [(G,) U, R, K], tile_col
    [(G,) U], b_tiles [(G,) nct, T, F]; returns [(G,) U, R, F] float32.
    The trip count is K: lanes past K are never read. Multiply and add
    are rounded separately, in ascending kk, as in
    ``ragged_ell_spmm_ref``.
    """
    grouped = cols.dim() == 4
    if not grouped:
        cols, vals, tile_col, b_tiles = (cols[None], vals[None],
                                         tile_col[None], b_tiles[None])
    g, u, r, k = cols.shape
    f = b_tiles.shape[-1]
    bt = _gather_b_tiles(b_tiles, tile_col)                  # [G, U, T, F]
    acc = torch.zeros((g, u, r, f), dtype=torch.float32,
                      device=b_tiles.device)
    for kk in range(k):
        idx = cols[..., kk].long()[..., None].expand(g, u, r, f)
        rows = torch.gather(bt, 2, idx)                      # [G, U, R, F]
        acc = acc + vals[..., kk, None].float() * rows
    return acc if grouped else acc[0]


def ragged_ell_spmm_ref(cols: torch.Tensor, vals: torch.Tensor,
                        tile_col: torch.Tensor, unit_k: torch.Tensor,
                        b_tiles: torch.Tensor) -> torch.Tensor:
    """Per-unit ragged ELL products (masked Kmax loop, per-unit live K).

    cols [(G,) U, R, Kmax] tile-local, vals [(G,) U, R, Kmax],
    tile_col [(G,) U], unit_k [(G,) U], b_tiles [(G,) nct, T, F];
    returns [(G,) U, R, F] float32. As in the reference the mask sits on
    the values, so a masked lane still multiplies 0 by its B row.
    """
    grouped = cols.dim() == 4
    if not grouped:
        cols, vals, tile_col, unit_k, b_tiles = (
            cols[None], vals[None], tile_col[None], unit_k[None],
            b_tiles[None])
    g, u, r, kmax = cols.shape
    f = b_tiles.shape[-1]
    bt = _gather_b_tiles(b_tiles, tile_col)                  # [G, U, T, F]
    acc = torch.zeros((g, u, r, f), dtype=torch.float32,
                      device=b_tiles.device)
    for kk in range(kmax):
        idx = cols[..., kk].long()[..., None].expand(g, u, r, f)
        rows = torch.gather(bt, 2, idx)                      # [G, U, R, F]
        v = torch.where((kk < unit_k)[..., None], vals[..., kk],
                        torch.zeros((), dtype=vals.dtype, device=vals.device))
        acc = acc + v[..., None] * rows
    return acc if grouped else acc[0]


def ragged_ell_rows_ref(cols: torch.Tensor, vals: torch.Tensor,
                        tile_col: torch.Tensor, unit_k: torch.Tensor,
                        b_tiles: torch.Tensor, plan: SegmentPlan,
                        out: torch.Tensor) -> torch.Tensor:
    """The sparse engine's rows added onto ``out`` in place.

    cols/vals [G, U, R, Kmax], tile_col/unit_k [G, U], b_tiles
    [G, nct, T, F], ``plan`` (a ``SegmentPlan`` over the G * U * R unit
    rows onto G * P padded rows) and ``out`` [G, P, F]:
    ``ragged_ell_spmm_ref``, then ``segment_sum`` over the plan in its
    order, then ``out += `` the sum. Returns ``out``.
    """
    g, u, r, _ = cols.shape
    f = b_tiles.shape[-1]
    prod = ragged_ell_spmm_ref(cols, vals, tile_col, unit_k, b_tiles)
    rows = segment_sum(prod.reshape(g * u * r, f), plan)
    return out.add_(rows.reshape(out.shape))
