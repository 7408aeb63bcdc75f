"""Sparse engine: the ragged single-launch ELL SpMM and the fixed-K one.

Port of ``repro.kernels.ell_spmm``:

  * ``ragged_ell_rows`` — the sparse engine as the main path runs it
    (``"ragged"`` dispatch): the TPU kernel ``_ragged_ell_kernel``'s
    products, summed onto output rows in the order of the ELL
    ``SegmentPlan`` and added onto the dense engine's rows, in place, by
    one launch of ``csrc/ragged_ell_spmm.cu`` for a whole group (the
    group axis ``G`` is a grid dimension);
  * ``ragged_ell_spmm`` — the TPU kernel's own function, per-unit
    products over every K width: the same kernel with every unit row its
    own segment and nothing to add onto;
  * ``ell_spmm_rows`` — one fixed-K class band (a bucket of
    ``repro_torch.core.formats.ell_buckets``) as the "fused"/"loop"
    dispatches run it: the TPU kernel ``_ell_kernel``'s products, summed
    onto output rows in the order of the band's ``BandPlan`` (a row that
    several bands reach carries its running sum from band to band) and
    added onto the dense engine's rows, in place, by one launch of
    ``csrc/ell_spmm.cu`` per band for a whole group;
  * ``ell_spmm`` — the TPU kernel's own function, per-unit products of
    one bucket: the same kernel with every unit row its own row and
    nothing to add onto.

Both CUDA sources share their row loop (``csrc/ell_rows.cuh``). On CPU
tensors each function runs its plain version in
``repro_torch.kernels.ref``.

The module also keeps its own copy of the reference's K-band helpers
(``merge_bands``, ``_bands_of``, ``_band_tables``, ``DEFAULT_MAX_BANDS``):
the port's shape classes plan their band slots with them. The ragged
kernel loops every unit to Kmax and the band kernel to its band's K, so
band plans change class shapes and the per-K dispatches' launches,
never results.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import BandPlan, SegmentPlan
from repro_torch.device import resolve_device

from . import _build
from .ref import (ell_spmm_ref, ell_spmm_rows_ref, ragged_ell_rows_ref,
                  ragged_ell_spmm_ref)

# Band-merge cap of the class band plans (the reference's value).
DEFAULT_MAX_BANDS = 4

# Launches of the CUDA kernels since the last reset
# (ops.reset_launch_counts): ``launches`` counts the ragged kernel
# (ragged_ell_rows and ragged_ell_spmm), ``fixed_k_launches`` the fixed-K
# one (ell_spmm_rows and ell_spmm).
launches = 0
fixed_k_launches = 0

_fn = None
_fixed_fn = None


def merge_bands(runs, max_bands: int) -> tuple:
    """Merge descending-K (K, n_units) runs down to ``max_bands`` bands.

    Adjacent runs merge into the wider K; the pair chosen at each step
    is the one adding the least padded-MAC waste
    ``(K_left - K_right) * n_right``. Deterministic (first minimum
    wins), returns a tuple of (K, n_units) with K strictly descending.
    """
    merged: list = []
    for k, n in runs:
        if n <= 0:
            continue
        if merged and merged[-1][0] == int(k):
            merged[-1][1] += int(n)
        else:
            merged.append([int(k), int(n)])
    while len(merged) > max_bands:
        best = min(range(len(merged) - 1),
                   key=lambda i: (merged[i][0] - merged[i + 1][0])
                   * merged[i + 1][1])
        merged[best][1] += merged[best + 1][1]
        del merged[best + 1]
    return tuple((k, n) for k, n in merged)


def _bands_of(segments, u: int, kmax: int, max_bands: int) -> tuple:
    """Normalize ``segments`` into a K-descending band plan.

    Empty segments (or any non-descending order) collapse to one
    Kmax-wide band; band Ks are clamped to the slab width.
    """
    if u == 0:
        return ()
    segs = tuple((int(k), int(n)) for k, n in segments if int(n) > 0)
    if not segs or sum(n for _, n in segs) != u:
        return ((kmax, u),)
    ks = [k for k, _ in segs]
    if any(ks[i] < ks[i + 1] for i in range(len(ks) - 1)):
        return ((kmax, u),)
    segs = tuple((min(k, kmax), n) for k, n in segs)
    return merge_bands(segs, max_bands)


def _band_tables(bands) -> tuple:
    """(band_ks, band_counts, band_offs) of a band plan; ``band_offs``
    holds the starting unit index of every band past the first."""
    band_ks = tuple(k for k, _ in bands)
    band_counts = tuple(n for _, n in bands)
    offs, at = [], 0
    for _, n in bands[:-1]:
        at += n
        offs.append(at)
    return band_ks, band_counts, tuple(offs)


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("ragged_ell_spmm")
        fn = lib.ragged_ell_rows_f32
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _check(cond: bool, msg: str, what: str = "ragged_ell_spmm") -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _checked(cols, vals, tile_col, unit_k, b_tiles, dev, what) -> tuple:
    """The inputs with a group axis, after the checks both ragged
    functions share; (cols, vals, tile_col, unit_k, b_tiles, grouped)."""
    grouped = cols.dim() == 4
    if not grouped:
        cols, vals, tile_col, unit_k, b_tiles = (
            cols[None], vals[None], tile_col[None], unit_k[None],
            b_tiles[None])
    _check(cols.dim() == 4 and b_tiles.dim() == 4,
           "expected cols/vals [G,U,R,Kmax] and b_tiles [G,nct,T,F]", what)
    g, u, r, kmax = cols.shape
    _check(tuple(vals.shape) == (g, u, r, kmax)
           and tuple(tile_col.shape) == (g, u)
           and tuple(unit_k.shape) == (g, u) and b_tiles.shape[0] == g,
           f"shapes differ: cols {tuple(cols.shape)}, vals "
           f"{tuple(vals.shape)}, tile_col {tuple(tile_col.shape)}, unit_k "
           f"{tuple(unit_k.shape)}, b_tiles {tuple(b_tiles.shape)}", what)
    _check(cols.dtype == torch.int32 and tile_col.dtype == torch.int32
           and unit_k.dtype == torch.int32 and vals.dtype == torch.float32
           and b_tiles.dtype == torch.float32,
           "expected int32 cols/tile_col/unit_k and float32 vals/B", what)
    for x in (cols, vals, tile_col, unit_k, b_tiles):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}", what)
        _check(dev.type == "cpu" or x.is_contiguous(),
               "CUDA kernel needs contiguous tensors", what)
    _check(dev.type == "cpu" or g * u * r < 2 ** 31,
           f"{g * u * r} unit rows: the kernel numbers them in 32 bits",
           what)
    return cols, vals, tile_col, unit_k, b_tiles, grouped


def _launch(cols, vals, tile_col, unit_k, b_tiles, plan, out, n_slots,
            dev) -> None:
    """One kernel launch; ``plan`` None = unit mode."""
    g, u, r, kmax = cols.shape
    _, nct, t, f = b_tiles.shape
    if not (g and n_slots and f):
        return
    lib, fn = _kernel()
    idx = ((None,) * 3 if plan is None else
           (plan.order.data_ptr(), plan.offsets.data_ptr(),
            plan.live.data_ptr()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cols.data_ptr(), vals.data_ptr(), tile_col.data_ptr(),
                 unit_k.data_ptr(), b_tiles.data_ptr(), *idx, out.data_ptr(),
                 g, n_slots, u, r, kmax, nct, t, f, stream)
    _build.check(lib, err, "ragged_ell_spmm launch")
    global launches
    with _build.count_lock:
        launches += 1


def ragged_ell_rows(cols: torch.Tensor, vals: torch.Tensor,
                    tile_col: torch.Tensor, unit_k: torch.Tensor,
                    b_tiles: torch.Tensor, plan: SegmentPlan,
                    out: torch.Tensor, *, device="cuda") -> torch.Tensor:
    """The sparse engine's rows, added onto ``out`` in place.

    cols/vals [G, U, R, Kmax] (int32 tile-local / f32), tile_col/unit_k
    [G, U] int32, b_tiles [G, nct, T, F] f32, ``plan`` the ELL
    ``SegmentPlan`` (entries ``g*U*R + u*R + r`` onto segments
    ``g*P + row``, the sentinel dropped, with its ``live`` table) and
    ``out`` [G, P, F] f32, which holds the dense engine's rows. Each row
    with ELL entries becomes ``out[row] + sum of its unit rows' products``
    (the sum in plan order, from +0); rows without one are not touched.
    Returns ``out``.

    Every tensor must lie on ``device``. CPU tensors take the plain
    version (``ragged_ell_spmm_ref``, ``segment_sum``, then the add);
    CUDA tensors launch the kernel or raise.
    """
    what = "ragged_ell_rows"
    dev = resolve_device(device)
    cols, vals, tile_col, unit_k, b_tiles, _ = _checked(
        cols, vals, tile_col, unit_k, b_tiles, dev, what)
    g, u, r, _ = cols.shape
    f = b_tiles.shape[-1]
    n_seg = plan.lengths.shape[0]
    _check(out.dim() == 3 and out.shape[0] == g and out.shape[2] == f
           and out.shape[0] * out.shape[1] == n_seg
           and out.dtype == torch.float32 and out.device == dev,
           f"out {tuple(out.shape)} {out.dtype} on {out.device}: want "
           f"float32 [{g}, {n_seg // max(g, 1)}, {f}] on {dev}", what)
    _check(plan.n_entries == u * r and plan.order.device == dev,
           f"plan of {plan.n_entries} entries on {plan.order.device}, want "
           f"{u * r} on {dev}", what)
    if dev.type == "cpu":
        return ragged_ell_rows_ref(cols, vals, tile_col, unit_k, b_tiles,
                                   plan, out)
    _check(plan.live.dim() == 2 and plan.live.shape[0] == g,
           f"plan needs its live table [{g}, L] (segment_live)", what)
    for x in (plan.order, plan.offsets, plan.live):
        _check(x.dtype == torch.int64 and x.is_contiguous()
               and x.device == dev, "plan order/offsets/live must be "
               f"contiguous int64 on {dev}", what)
    _check(plan.offsets.shape[0] == n_seg + 1, f"{plan.offsets.shape[0]} "
           f"offsets for {n_seg} segments", what)
    _check(out.is_contiguous(), "CUDA kernel needs a contiguous out", what)
    _launch(cols, vals, tile_col, unit_k, b_tiles, plan, out,
            plan.live.shape[1], dev)
    return out


def ragged_ell_spmm(cols: torch.Tensor, vals: torch.Tensor,
                    tile_col: torch.Tensor, unit_k: torch.Tensor,
                    b_tiles: torch.Tensor, *, device="cuda") -> torch.Tensor:
    """Per-unit ELL products over the concatenated ragged unit array.

    cols [(G,) U, R, Kmax] int32 (tile-local), vals [(G,) U, R, Kmax] f32,
    tile_col [(G,) U] int32, unit_k [(G,) U] int32, b_tiles
    [(G,) nct, T, F] f32  ->  [(G,) U, R, F] f32. ONE launch covers every
    K width. Every tensor must lie on ``device``; CPU tensors take the
    plain version, CUDA tensors launch the kernel or raise. Indices must
    be in range (``cols < T``, ``tile_col < nct``): partitions guarantee
    it and ``Engine.register`` checks it on the host.
    """
    dev = resolve_device(device)
    cols, vals, tile_col, unit_k, b_tiles, grouped = _checked(
        cols, vals, tile_col, unit_k, b_tiles, dev, "ragged_ell_spmm")
    if dev.type == "cpu":
        out = ragged_ell_spmm_ref(cols, vals, tile_col, unit_k, b_tiles)
        return out if grouped else out[0]
    g, u, r, _ = cols.shape
    out = torch.empty((g, u, r, b_tiles.shape[-1]), dtype=torch.float32,
                      device=dev)
    _launch(cols, vals, tile_col, unit_k, b_tiles, None, out, u * r, dev)
    return out if grouped else out[0]


def _fixed_kernel():
    global _fixed_fn
    if _fixed_fn is None:
        lib = _build.library("ell_spmm")
        fn = lib.ell_spmm_rows_f32
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fixed_fn = (lib, fn)
    return _fixed_fn


def _packed(x: torch.Tensor, first: int) -> bool:
    """Axes ``first..`` of ``x`` are laid out row-major without gaps
    (the strides of size-1 axes do not matter)."""
    want = 1
    for d in reversed(range(first, x.dim())):
        if x.shape[d] != 1 and x.stride(d) != want:
            return False
        want *= x.shape[d]
    return True


def _fixed_checked(cols, vals, tile_col, b_tiles, dev, what) -> tuple:
    """The inputs with a group axis, after the checks both fixed-K
    functions share; (cols, vals, tile_col, b_tiles, grouped)."""
    grouped = cols.dim() == 4
    if not grouped:
        cols, vals, tile_col, b_tiles = (cols[None], vals[None],
                                         tile_col[None], b_tiles[None])
    _check(cols.dim() == 4 and b_tiles.dim() == 4,
           "expected cols/vals [G,U,R,K] and b_tiles [G,nct,T,F]", what)
    g, u, r, k = cols.shape
    _check(tuple(vals.shape) == (g, u, r, k)
           and tuple(tile_col.shape) == (g, u) and b_tiles.shape[0] == g,
           f"shapes differ: cols {tuple(cols.shape)}, vals "
           f"{tuple(vals.shape)}, tile_col {tuple(tile_col.shape)}, "
           f"b_tiles {tuple(b_tiles.shape)}", what)
    _check(cols.dtype == torch.int32 and tile_col.dtype == torch.int32
           and vals.dtype == torch.float32
           and b_tiles.dtype == torch.float32,
           "expected int32 cols/tile_col and float32 vals/B", what)
    for x in (cols, vals, tile_col, b_tiles):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}", what)
    _check(dev.type == "cpu" or (
        cols.stride() == vals.stride() and _packed(cols, 3)
        and (u <= 1 or cols.stride(1) == r * _row_stride(cols))
        and _packed(tile_col, 1) and b_tiles.is_contiguous()),
        "CUDA kernel needs cols and vals in one layout with a contiguous K "
        "axis and packed unit and row axes (a K slice of a contiguous "
        "array, as ell_buckets gives), a contiguous tile_col unit axis and "
        "contiguous B", what)
    _check(dev.type == "cpu" or (g * u * r < 2 ** 31
                                 and u * r * _row_stride(cols) < 2 ** 31),
           f"{g} x {u * r} unit rows: the kernel numbers them in 32 bits",
           what)
    return cols, vals, tile_col, b_tiles, grouped


def _row_stride(cols: torch.Tensor) -> int:
    """Elements from one unit row's lanes to the next (cols [G, U, R, K])."""
    return cols.stride(2) if cols.shape[2] > 1 else cols.stride(1)


def _fixed_launch(cols, vals, tile_col, b_tiles, band, carry, out, n_slots,
                  n_rows, out_sg, dev) -> None:
    """One launch of the fixed-K kernel; ``band`` None = unit mode."""
    g, u, r, k = cols.shape
    _, nct, t, f = b_tiles.shape
    lib, fn = _fixed_kernel()
    plan = ((None,) * 4 if band is None else
            (band.order.data_ptr(), band.offsets.data_ptr(),
             band.rows.data_ptr(), band.carry.data_ptr()))
    n_carry = 0 if band is None else band.n_carry
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cols.data_ptr(), vals.data_ptr(), tile_col.data_ptr(),
                 b_tiles.data_ptr(), *plan,
                 None if carry is None else carry.data_ptr(), out.data_ptr(),
                 g, n_slots, u, r, k, nct, t, f, n_rows, n_carry,
                 cols.stride(0), _row_stride(cols), tile_col.stride(0),
                 out_sg, stream)
    _build.check(lib, err, "ell_spmm launch")
    global fixed_k_launches
    with _build.count_lock:
        fixed_k_launches += 1


def ell_spmm_rows(cols: torch.Tensor, vals: torch.Tensor,
                  tile_col: torch.Tensor, b_tiles: torch.Tensor,
                  band: BandPlan, out: torch.Tensor,
                  carry: torch.Tensor = None, *, device="cuda"
                  ) -> torch.Tensor:
    """One class band's ELL rows, added onto ``out`` in place.

    cols/vals [G, U_b, R, K] (int32 tile-local / f32; views of the
    ragged slab, ``ell_buckets``, read in place), tile_col
    [G, U_b] int32, b_tiles [G, nct, T, F] f32, ``band`` the band's
    ``BandPlan`` (``ReductionPlan.ell_bands``), ``out`` [G, P, F] f32,
    which holds the dense engine's rows, and ``carry`` [G, band.n_carry,
    F] f32 (needed when ``band.n_carry`` > 0), one buffer shared by all
    bands of the call. Each live row of the band sums its unit rows'
    products in plan order, starting from the sum an earlier band left in
    ``carry`` or from +0; the sum then goes to ``carry`` when a later
    band reaches the row, else onto ``out[row]``. Rows the band does not
    reach are not touched. Run over the bands in order, this is
    ``out + scatter_ell_partials`` of the bands' products, bit for bit.
    Returns ``out``.

    Every tensor must lie on ``device``. CPU tensors take the plain
    version (``ell_spmm_rows_ref``); CUDA tensors launch the kernel (one
    launch, also for a band that reaches no row) or raise.
    """
    what = "ell_spmm_rows"
    dev = resolve_device(device)
    cols, vals, tile_col, b_tiles, _ = _fixed_checked(
        cols, vals, tile_col, b_tiles, dev, what)
    g, u, r, _ = cols.shape
    f = b_tiles.shape[-1]
    _check(out.dim() == 3 and out.shape[0] == g and out.shape[2] == f
           and out.dtype == torch.float32 and out.device == dev,
           f"out {tuple(out.shape)} {out.dtype} on {out.device}: want "
           f"float32 [{g}, P, {f}] on {dev}", what)
    n_slots = band.rows.shape[-1]
    for x in band[:4]:
        _check(x.dtype == torch.int64 and x.device == dev
               and (dev.type == "cpu" or x.is_contiguous()),
               f"band plan tensors must be contiguous int64 on {dev}", what)
    _check(tuple(band.rows.shape) == (g, n_slots)
           and tuple(band.carry.shape) == (g, n_slots)
           and band.offsets.shape[0] == g * n_slots + 1,
           f"band plan rows {tuple(band.rows.shape)}, carry "
           f"{tuple(band.carry.shape)}, offsets {band.offsets.shape[0]} do "
           f"not fit a group of {g}", what)
    if band.n_carry:
        _check(carry is not None and carry.dtype == torch.float32
               and tuple(carry.shape) == (g, band.n_carry, f)
               and carry.device == dev, f"the band carries rows: want a "
               f"float32 carry [{g}, {band.n_carry}, {f}] on {dev}", what)
    else:
        carry = None
    if dev.type == "cpu":
        return ell_spmm_rows_ref(cols, vals, tile_col, b_tiles, band, out,
                                 carry)
    _check(out.is_contiguous() and (carry is None or carry.is_contiguous()),
           "CUDA kernel needs a contiguous out and carry", what)
    if g and f:
        _fixed_launch(cols, vals, tile_col, b_tiles, band, carry, out,
                      n_slots, out.shape[1], 0, dev)
    return out


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, tile_col: torch.Tensor,
             b_tiles: torch.Tensor, *, out: torch.Tensor = None,
             device="cuda") -> torch.Tensor:
    """Per-unit ELL products of one fixed-K bucket.

    cols [(G,) U, R, K] int32 (tile-local), vals [(G,) U, R, K] f32,
    tile_col [(G,) U] int32, b_tiles [(G,) nct, T, F] f32 -> [(G,) U, R,
    F] f32; one launch for the whole group, of ``ell_spmm_rows``'s kernel
    with every unit row its own row and nothing to add onto.
    ``cols``/``vals`` may be views of the ragged [.., Kmax] slab
    (``ell_buckets``): the kernel reads them in place, as long as both
    share one layout with a contiguous K axis and packed unit and row
    axes. ``out`` (optional) is where the products go, e.g. a unit slice
    of a [G, U_all, R, F] buffer; its unit, row and feature axes must be
    contiguous. Every tensor must lie on ``device``; CPU tensors take the
    plain version, CUDA tensors launch the kernel or raise. Indices must
    be in range (``cols < T``, ``tile_col < nct``).
    """
    what = "ell_spmm"
    dev = resolve_device(device)
    if cols.dim() == 3 and out is not None:
        out = out[None]
    cols, vals, tile_col, b_tiles, grouped = _fixed_checked(
        cols, vals, tile_col, b_tiles, dev, what)
    g, u, r, _ = cols.shape
    f = b_tiles.shape[-1]
    _check(out is None or (tuple(out.shape) == (g, u, r, f)
                           and out.dtype == torch.float32
                           and out.device == dev),
           f"out must be float32 {(g, u, r, f)} on {dev}", what)
    if dev.type == "cpu":
        res = ell_spmm_ref(cols, vals, tile_col, b_tiles)
        if out is not None:
            res = out.copy_(res)
        return res if grouped else res[0]
    if out is None:
        out = torch.empty((g, u, r, f), dtype=torch.float32, device=dev)
    _check(_packed(out, 1), "out needs contiguous unit, row and feature axes",
           what)
    if g and u and r and f:
        _fixed_launch(cols, vals, tile_col, b_tiles, None, None, out, u * r,
                      0, out.stride(0), dev)
    return out if grouped else out[0]
