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

from repro_torch.core.formats import SegmentPlan, segment_sum
from repro_torch.device import pin_ieee_f32

from .bands import (DEFAULT_MAX_BANDS, _band_tables, _bands_of,
                    check_max_bands)


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


def band_bounds(u: int, kmax: int, segments=(), max_bands: int = None,
                device=None) -> tuple:
    """(lanes, bound) of the ragged kernel's K bands over ``u`` units:
    ``bound`` [U] int64 on ``device``, the K of each unit's band (the
    reference's ``_bands_of`` / ``_band_tables``: unit u's band is
    ``sum(u >= off)``), built on the device from the band table's
    constants (no copy from the host), and ``lanes`` the widest band's
    K, past which no unit reads."""
    max_bands = check_max_bands(DEFAULT_MAX_BANDS if max_bands is None
                                else max_bands)
    bands = _bands_of(segments, u, kmax, max_bands)
    ks, _, offs = _band_tables(bands)
    unit = torch.arange(u, device=device)
    bound = torch.full((u,), ks[0] if ks else 0, dtype=torch.int64,
                       device=device)
    for off, k in zip(offs, ks[1:]):
        bound = torch.where(unit >= off, k, bound)
    return (ks[0] if ks else 0), bound


def _chains(cols, vals, tile_col, b_tiles, lanes, bound, unit_k=None):
    """Per-unit products [G, U, R, F] float32 of grouped operands: unit
    u's chain runs from +0 in ascending kk over the lanes kk < bound[u]
    (``bound`` [U], or [G, U]), each multiply and add rounded on its own;
    lanes past the bound are never read into a sum. ``unit_k`` masks the
    VALUES (a masked lane multiplies 0 by its B row, as in the
    reference); without it every lane inside the bound is live.
    ``lanes``: no unit reads past it (at most Kmax)."""
    g, u, r, _ = cols.shape
    f = b_tiles.shape[-1]
    bt = _gather_b_tiles(b_tiles, tile_col)                  # [G, U, T, F]
    bound = bound.to(b_tiles.device).expand(g, u)[..., None, None]
    acc = torch.zeros((g, u, r, f), dtype=torch.float32,
                      device=b_tiles.device)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    for kk in range(lanes):
        idx = cols[..., kk].long()[..., None].expand(g, u, r, f)
        rows = torch.gather(bt, 2, idx)                      # [G, U, R, F]
        v = vals[..., kk]
        if unit_k is not None:
            v = torch.where((kk < unit_k)[..., None], v, zero)
        acc = torch.where(kk < bound, acc + v[..., None].float()
                          * rows.float(), acc)
    return acc


def ragged_ell_spmm_ref(cols: torch.Tensor, vals: torch.Tensor,
                        tile_col: torch.Tensor, unit_k: torch.Tensor,
                        b_tiles: torch.Tensor, *, segments: tuple = (),
                        max_bands: int = None) -> torch.Tensor:
    """Per-unit ragged ELL products (masked, each unit to its band's K).

    cols [(G,) U, R, Kmax] tile-local, vals [(G,) U, R, Kmax],
    tile_col [(G,) U], unit_k [(G,) U], b_tiles [(G,) nct, T, F];
    returns [(G,) U, R, F] float32. ``segments`` (the partition's
    descending (K, n_units) runs) merged to at most ``max_bands`` bands
    (default ``DEFAULT_MAX_BANDS``) bound each unit's lanes, as the TPU
    kernel's band switch does; ``segments=()`` is one Kmax band. As in
    the reference the mask sits on the values, so a masked lane inside
    the band still multiplies 0 by its B row, and both factors are upcast
    to float32 before they are multiplied.
    """
    grouped = cols.dim() == 4
    if not grouped:
        cols, vals, tile_col, unit_k, b_tiles = (
            cols[None], vals[None], tile_col[None], unit_k[None],
            b_tiles[None])
    _, u, _, kmax = cols.shape
    lanes, bound = band_bounds(u, kmax, segments, max_bands, cols.device)
    acc = _chains(cols, vals, tile_col, b_tiles, lanes, bound, unit_k)
    return acc if grouped else acc[0]


def ragged_ell_rows_ref(cols: torch.Tensor, vals: torch.Tensor,
                        tile_col: torch.Tensor, unit_k: torch.Tensor,
                        b_tiles: torch.Tensor, plan: SegmentPlan,
                        out: torch.Tensor, *, segments: tuple = (),
                        max_bands: int = None) -> torch.Tensor:
    """The sparse engine's rows added onto ``out`` in place.

    cols/vals [G, U, R, Kmax], tile_col/unit_k [G, U], b_tiles
    [G, nct, T, F], ``plan`` (a ``SegmentPlan`` over the G * U * R unit
    rows onto G * P padded rows) and ``out`` [G, P, F]:
    ``ragged_ell_spmm_ref`` (its K bands from ``segments`` /
    ``max_bands``), then ``segment_sum`` over the plan in its order, then
    ``out += `` the sum. Returns ``out``.
    """
    g, u, r, _ = cols.shape
    f = b_tiles.shape[-1]
    prod = ragged_ell_spmm_ref(cols, vals, tile_col, unit_k, b_tiles,
                               segments=segments, max_bands=max_bands)
    rows = segment_sum(prod.reshape(g * u * r, f), plan)
    return out.add_(rows.reshape(out.shape))


def ell_spmm_rows_ref(cols: torch.Tensor, vals: torch.Tensor,
                      tile_col: torch.Tensor, b_tiles: torch.Tensor,
                      plan: SegmentPlan, out: torch.Tensor,
                      bucket_k: torch.Tensor) -> torch.Tensor:
    """One layer's fixed-K ELL rows, every bucket at once, added onto
    ``out`` in place.

    cols/vals [G, U, R, Kmax] (the ragged slab), tile_col [G, U],
    b_tiles [G, nct, T, F], ``plan`` the ELL ``SegmentPlan`` (as for
    ``ragged_ell_rows_ref``), ``out`` [G, P, F] and ``bucket_k`` [U] the
    K of each unit's bucket (``ReductionPlan.ell_bucket_k``). Each unit's
    product is its bucket's fixed-K chain (``ell_spmm_ref`` over the
    bucket's K lanes, no value mask; lanes past K are never read), then
    ``segment_sum`` over the plan, then ``out += `` the sum: the per-bucket
    products scattered in the order of ``plan.ell`` ("fused") and added
    onto ``out``, bit for bit. Returns ``out``.
    """
    g, u, r, kmax = cols.shape
    f = b_tiles.shape[-1]
    prod = _chains(cols, vals, tile_col, b_tiles, kmax, bucket_k)
    rows = segment_sum(prod.reshape(g * u * r, f), plan)
    return out.add_(rows.reshape(out.shape))


def coo_rows_ref(cols: torch.Tensor, vals: torch.Tensor, b: torch.Tensor,
                 plan: SegmentPlan, out: torch.Tensor) -> torch.Tensor:
    """The flexible engine's rows added onto ``out`` in place.

    cols/vals [G, nnz] (int32 B rows / float32 or bfloat16), b [G, N, F]
    (B's rows, float32 or bfloat16), ``plan`` the COO ``SegmentPlan``
    (entries ``g*nnz + i`` onto segments ``g*P + row``) and ``out``
    [G, P, F] float32: each entry's message ``vals[e] * B[cols[e]]``
    (both upcast to float32, one rounded multiply), ``segment_sum`` of
    the messages over the plan in its order, then ``out += `` the sum.
    Returns ``out``.
    """
    g, nnz = cols.shape
    f = b.shape[-1]
    idx = cols.long()[..., None].expand(g, nnz, f)
    msgs = vals[..., None].float() * torch.gather(b, 1, idx).float()
    rows = segment_sum(msgs.reshape(g * nnz, f), plan)
    return out.add_(rows.reshape(out.shape))
