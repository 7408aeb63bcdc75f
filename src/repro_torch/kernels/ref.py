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


def head_values(vals: torch.Tensor, f: int) -> torch.Tensor:
    """Multi-head values [..., H] spread over ``f`` features, float32:
    head h's value over its block of F/H columns (columns h*F/H ..
    (h+1)*F/H - 1), the factor each column of B is multiplied by."""
    return vals.float().repeat_interleave(f // vals.shape[-1], dim=-1)


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
    g, n_t = tiles.shape[:2]
    t = tiles.shape[-1]
    f = b_tiles.shape[-1]
    if tiles.dim() == 5:
        prod = bsr_heads_ref(tiles, tile_col, b_tiles)
    else:
        prod = bsr_spmm_ref(tiles, tile_col, b_tiles)
    out = segment_sum(prod.reshape(g * n_t, t * f), plan)
    return rounded_to(out.reshape(g, -1, t, f), b_tiles.dtype)


def bsr_heads_ref(tiles: torch.Tensor, tile_col: torch.Tensor,
                  b_tiles: torch.Tensor) -> torch.Tensor:
    """Per-tile products of multi-head tiles [G, n_t, H, T, T]: column
    block h of B (F/H columns) times head h's tile. Returns
    [G, n_t, T, F] float32."""
    g, n_t, h, t, _ = tiles.shape
    f = b_tiles.shape[-1]
    pin_ieee_f32()
    bt = _gather_b_tiles(b_tiles, tile_col).float()          # [G,n_t,T,F]
    bt = bt.reshape(g, n_t, t, h, f // h).transpose(2, 3)    # [G,n_t,H,T,F/H]
    out = torch.matmul(tiles.float(), bt)                     # [G,n_t,H,T,F/H]
    return out.transpose(2, 3).reshape(g, n_t, t, f)


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
    ``lanes``: no unit reads past it (at most Kmax). Multi-head ``vals``
    [G, U, R, Kmax, H] scale each head's block of F/H columns by that
    head's value (``head_values``)."""
    g, u, r, _ = cols.shape
    f = b_tiles.shape[-1]
    heads = vals.dim() == cols.dim() + 1
    bt = _gather_b_tiles(b_tiles, tile_col)                  # [G, U, T, F]
    bound = bound.to(b_tiles.device).expand(g, u)[..., None, None]
    acc = torch.zeros((g, u, r, f), dtype=torch.float32,
                      device=b_tiles.device)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    for kk in range(lanes):
        idx = cols[..., kk].long()[..., None].expand(g, u, r, f)
        rows = torch.gather(bt, 2, idx)                      # [G, U, R, F]
        v = vals[:, :, :, kk]
        if unit_k is not None:
            live = (kk < unit_k)[..., None]
            v = torch.where(live[..., None] if heads else live, v, zero)
        v = head_values(v, f) if heads else v[..., None].float()
        acc = torch.where(kk < bound, acc + v * rows.float(), acc)
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
    v = head_values(vals, f) if vals.dim() == 3 else vals[..., None].float()
    msgs = v * torch.gather(b, 1, idx).float()
    rows = segment_sum(msgs.reshape(g * nnz, f), plan)
    return out.add_(rows.reshape(out.shape))


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """LeakyReLU as the edge-coefficient kernel computes it: ``x`` where
    ``x > 0``, else ``slope * x`` (one rounded multiply)."""
    return torch.where(x > 0, x, x * slope)


def gat_row_stats_ref(offsets: torch.Tensor, cols: torch.Tensor,
                      s: torch.Tensor, t: torch.Tensor, slope: float
                      ) -> tuple:
    """Each row's softmax statistics over all its neighbours, per head.

    ``offsets`` [G * P + 1] int64 and ``cols`` [E] int32 are the rows'
    neighbour lists (row g*P + i's entries are ``cols[offsets[g*P+i] :
    offsets[g*P+i+1]]``, columns of member g), ``s`` [G, P, H] the
    destination scores, ``t`` [G, N, H] the source scores. Returns
    (m, d), each [G, P, H] float32: ``m`` the row maximum of
    LeakyReLU(s_i + t_j), taken as LeakyReLU(s_i + max_j t_j) (LeakyReLU
    is monotone), and ``d`` the denominator sum_j exp(LeakyReLU(s_i +
    t_j) - m). A row without a neighbour (class padding) reads m = d = 0.
    """
    g, p, h = s.shape
    lengths = offsets[1:] - offsets[:-1]
    seg = torch.arange(g * p, device=s.device).repeat_interleave(lengths)
    tj = t[seg // p, cols.long()].float()                          # [E, H]
    sf = s.reshape(g * p, h).float()
    if cols.shape[0] == 0:
        z = torch.zeros((g, p, h), dtype=torch.float32, device=s.device)
        return z, z.clone()
    tmax = torch.segment_reduce(tj, "max", lengths=lengths, axis=0,
                                unsafe=True)
    live = (lengths > 0)[:, None]
    m = torch.where(live, leaky_relu(sf + torch.where(live, tmax, 0.0),
                                     slope), 0.0)
    pe = torch.exp(leaky_relu(sf[seg] + tj, slope) - m[seg])
    d = torch.segment_reduce(pe, "sum", lengths=lengths, axis=0, unsafe=True)
    d = torch.where(live, d, 0.0)
    return m.reshape(g, p, h), d.reshape(g, p, h)


def _coef(valid, rows, cols, s, t, m, slope):
    """exp(LeakyReLU(s_row + t_col) - m_row) [..., H] where ``valid``,
    else +0; rows/cols index member g of s/m and t ([G, ...] leading)."""
    g = torch.arange(s.shape[0], device=s.device).reshape(
        (-1,) + (1,) * (rows.dim() - 1))
    r = torch.where(valid, rows.long(), 0)
    c = torch.where(valid, cols.long(), 0)
    e = leaky_relu(s[g, r] + t[g, c], slope) - m[g, r]
    return torch.where(valid[..., None], torch.exp(e), 0.0)


def gat_edge_coef_ref(part, s: torch.Tensor, t: torch.Tensor,
                      m: torch.Tensor, slope: float, tile: int) -> tuple:
    """The unnormalised attention coefficients of every stored entry of
    each engine's layout, per head: exp(LeakyReLU(s_i + t_j) - m_i), +0
    where the layout holds no entry (a stored value of 0: tile zeros, ELL
    lanes past ``unit_k`` and padded unit rows, class padding's COO
    triples).

    ``part`` is a grouped ``TriPartition`` whose values are the graph's
    pattern; ``s``/``m`` [G, P, H] (rows), ``t`` [G, N, H] (columns).
    Returns (dense [G, n_t, H, T, T], ell [G, U, R, Kmax, H], coo
    [G, nnz, H]) float32: the layouts the multi-head engines read.
    """
    T = tile
    ar = torch.arange(T, device=s.device)
    dt = part.dense
    rows = (dt.tile_row.long()[..., None] * T + ar)[..., :, None]
    cols = (dt.tile_col.long()[..., None] * T + ar)[..., None, :]
    rows, cols = torch.broadcast_tensors(rows, cols)          # [G,n_t,T,T]
    dense = _coef(dt.tiles != 0, rows, cols, s, t, m, slope)
    dense = dense.permute(0, 1, 4, 2, 3).contiguous()         # [G,n_t,H,T,T]
    el = part.ell
    erows = el.rows.long()[..., None].expand(el.cols.shape)
    ecols = el.tile_col.long()[..., None, None] * T + el.cols.long()
    ell = _coef(el.vals != 0, erows, ecols, s, t, m, slope)
    co = part.coo
    coo = _coef(co.vals != 0, co.rows, co.cols, s, t, m, slope)
    return dense, ell, coo
