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

from repro_torch.core.formats import BandPlan, SegmentPlan, segment_sum
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


def ell_spmm_rows_ref(cols: torch.Tensor, vals: torch.Tensor,
                      tile_col: torch.Tensor, b_tiles: torch.Tensor,
                      band: BandPlan, out: torch.Tensor,
                      carry: torch.Tensor = None) -> torch.Tensor:
    """One class band's ELL rows, added onto ``out`` in place.

    cols/vals [G, U_b, R, K], tile_col [G, U_b], b_tiles [G, nct, T, F],
    ``band`` the band's ``BandPlan`` (tensors), ``out`` [G, P, F] and
    ``carry`` [G, band.n_carry, F] (rows that several bands reach). Step
    by step: the per-unit products (``ell_spmm_ref``); per live row of
    the band, a sum started from the row's carried value (an earlier band
    reached it) or from +0, adding its unit rows' products one at a time
    in plan order; then the sum is stored in ``carry`` (a later band
    reaches the row) or added onto ``out``. Returns ``out``.
    """
    g, u, r, _ = cols.shape
    f = b_tiles.shape[-1]
    prod = ell_spmm_ref(cols, vals, tile_col, b_tiles).reshape(g, u * r, f)
    n_slots = band.rows.shape[1]
    gi, si = torch.nonzero(band.rows >= 0, as_tuple=True)
    slot = gi * n_slots + si
    begin = band.offsets[slot]
    n = band.offsets[slot + 1] - begin
    code = band.carry[gi, si]
    c = code >> 2
    carry_in = (code >= 0) & (code & 2 != 0)
    carry_out = (code >= 0) & (code & 1 != 0)
    acc = torch.zeros((slot.shape[0], f), dtype=torch.float32,
                      device=prod.device)
    if bool(carry_in.any()):
        acc[carry_in] = carry[gi[carry_in], c[carry_in]]
    for i in range(int(n.max()) if n.numel() else 0):
        m = i < n
        acc[m] = acc[m] + prod[gi[m], band.order[begin[m] + i]]
    if bool(carry_out.any()):
        carry[gi[carry_out], c[carry_out]] = acc[carry_out]
    add = ~carry_out
    rows = band.rows[gi[add], si[add]]
    out[gi[add], rows] = out[gi[add], rows] + acc[add]
    return out
