"""Plain PyTorch versions of the port's hand-written kernels.

Port of ``repro.kernels.ref`` for the two kernels on the main path. They
are what the kernel wrappers run for CPU tensors, what the "torch"
backend of ``repro_torch.core.hybrid_spmm`` runs on any device, and what
the kernels are held against on the card.

Both accept an optional leading group axis ``G`` on every argument.
"""
from __future__ import annotations

import torch


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
