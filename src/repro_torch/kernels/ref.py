"""Plain PyTorch versions of the port's hand-written kernels.

Port of ``repro.kernels.ref``. They are what the kernel wrappers run
for CPU tensors, what the "torch" backend of
``repro_torch.core.hybrid_spmm`` runs on any device, and what the
kernels are held against on the card.

The sparse ones accept an optional leading group axis ``G`` on every
argument; ``tile_matmul_ref`` is two-dimensional, as in the reference.

Types, as the reference's kernels take them: float32 or bfloat16
operands, upcast to float32 before they are multiplied (a product of two
bfloat16 values is exact in float32), float32 sums. The products come
out in float32, except ``tile_matmul_ref`` (A's type) and the dense
engine's rows (``bsr_spmm_rows_ref``), which the reference rounds to
B's type before anything is added onto them.
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


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at ``|x|``, in float64: 2^(e - 7)
    where 2^e <= |x| < 2^(e + 1); 0 at 0."""
    x = x.double().abs()
    _, e = torch.frexp(x)                   # |x| = m * 2^e, 1/2 <= m < 1
    return torch.where(x > 0, torch.ldexp(torch.ones_like(x), e - 8),
                       torch.zeros_like(x))


# The relative term of ``bf16_tolerance``, times |A| @ |B|.
BF16_REL = 2e-6


def bf16_tolerance(want: torch.Tensor, mag: torch.Tensor,
                   rounded: torch.Tensor = None) -> torch.Tensor:
    """The elementwise bound a bfloat16 result is held to against another
    computation of it, in float64: ``ulp_bf16(|want|) + BF16_REL * mag``,
    where ``mag`` is the product of the operands' absolute values (|A| @
    |B|): one bfloat16 rounding of the result apart, plus float32 sums of the
    same products taken in another order (the tensor cores sum each k16
    step in their own order). ``rounded``: the magnitude of a partial
    result that is rounded to bfloat16 on the way (the dense engine's rows
    in ``hybrid_spmm``), whose rounding may fall on either side as well:
    ``ulp_bf16(rounded)`` more."""
    bound = bf16_ulp(want) + BF16_REL * mag.double()
    return bound if rounded is None else bound + bf16_ulp(rounded)


def _gather_b_tiles(b_tiles: torch.Tensor, tile_col: torch.Tensor):
    """b_tiles [G, nct, T, F], tile_col [G, n] -> [G, n, T, F]."""
    g = torch.arange(b_tiles.shape[0], device=b_tiles.device)[:, None]
    return b_tiles[g, tile_col.long()]


def bsr_spmm_ref(tiles: torch.Tensor, tile_col: torch.Tensor,
                 b_tiles: torch.Tensor) -> torch.Tensor:
    """Per-tile products of a BSR stack against tile-sliced B.

    tiles [(G,) n_t, T, T], tile_col [(G,) n_t], b_tiles [(G,) nct, T, F]
    returns [(G,) n_t, T, F] float32 (the caller sums over tile_row): the
    upcast operands multiplied in IEEE float32, as the reference's
    ``preferred_element_type=float32`` product.
    """
    grouped = tiles.dim() == 4
    if not grouped:
        tiles, tile_col, b_tiles = tiles[None], tile_col[None], b_tiles[None]
    pin_ieee_f32()
    out = torch.matmul(tiles.float(),
                       _gather_b_tiles(b_tiles, tile_col).float())
    return out if grouped else out[0]


def bsr_spmm_rows_ref(tiles: torch.Tensor, tile_col: torch.Tensor,
                      b_tiles: torch.Tensor, plan: SegmentPlan
                      ) -> torch.Tensor:
    """The dense engine: per-tile products summed per row tile.

    tiles [G, n_t, T, T], tile_col [G, n_t], b_tiles [G, nct, T, F] and
    ``plan`` (a ``SegmentPlan`` over the G * n_t tiles onto G * n_rt row
    tiles) -> [G, n_rt, T, F] float32: ``bsr_spmm_ref`` followed by
    ``segment_sum`` over the plan, in its order. Row tiles without a tile
    are 0. With a bfloat16 B each sum is then rounded to bfloat16 (and
    kept in float32): the reference's dense engine rounds its rows to B's
    type before the other engines' rows are added.
    """
    g, n_t, t, _ = tiles.shape
    f = b_tiles.shape[-1]
    prod = bsr_spmm_ref(tiles, tile_col, b_tiles)
    out = segment_sum(prod.reshape(g * n_t, t * f), plan)
    return rounded_to(out.reshape(g, -1, t, f), b_tiles.dtype)


def rounded_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float32 ``x`` rounded to ``dtype`` (to nearest even) and kept in
    float32; ``x`` itself where ``dtype`` is float32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


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
        acc = acc + vals[..., kk, None].float() * rows.float()
    return acc if grouped else acc[0]


def ragged_ell_spmm_ref(cols: torch.Tensor, vals: torch.Tensor,
                        tile_col: torch.Tensor, unit_k: torch.Tensor,
                        b_tiles: torch.Tensor) -> torch.Tensor:
    """Per-unit ragged ELL products (masked Kmax loop, per-unit live K).

    cols [(G,) U, R, Kmax] tile-local, vals [(G,) U, R, Kmax],
    tile_col [(G,) U], unit_k [(G,) U], b_tiles [(G,) nct, T, F];
    returns [(G,) U, R, F] float32. As in the reference the mask sits on
    the values, so a masked lane still multiplies 0 by its B row, and
    both factors are upcast to float32 before they are multiplied.
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
        acc = acc + v[..., None].float() * rows.float()
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
