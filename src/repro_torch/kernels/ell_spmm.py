"""Sparse engine: the ragged single-launch ELL SpMM and the fixed-K one.

Port of ``repro.kernels.ell_spmm``:

  * ``ragged_ell_spmm`` (TPU kernel ``_ragged_ell_kernel``) launches
    ``csrc/ragged_ell_spmm.cu``: one launch covers every K width and
    every member of a group (the group axis ``G`` is a grid dimension).
  * ``ell_spmm`` (TPU kernel ``_ell_kernel``) launches
    ``csrc/ell_spmm.cu`` for one fixed-K bucket of the ragged array
    (``repro_torch.core.formats.ell_buckets``): the "fused"/"loop"
    dispatches launch it once per bucket for the whole group.

On CPU tensors each runs its plain version in
``repro_torch.kernels.ref``. The output is per-unit partial products;
the caller reduces them onto the unit row ids.

The module also keeps its own copy of the reference's K-band helpers
(``merge_bands``, ``_bands_of``, ``_band_tables``, ``DEFAULT_MAX_BANDS``):
the port's shape classes plan their band slots with them. The CUDA
kernel itself loops every unit to Kmax, so band plans change class
shapes, never results.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device

from . import _build
from .ref import ell_spmm_ref, ragged_ell_spmm_ref

# Band-merge cap of the class band plans (the reference's value).
DEFAULT_MAX_BANDS = 4

# Launches of the CUDA kernels since the last reset
# (ops.reset_launch_counts): ``launches`` counts ragged_ell_spmm,
# ``fixed_k_launches`` counts ell_spmm.
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
        fn = lib.ragged_ell_spmm_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ragged_ell_spmm: {msg}")


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
    grouped = cols.dim() == 4
    if not grouped:
        cols, vals, tile_col, unit_k, b_tiles = (
            cols[None], vals[None], tile_col[None], unit_k[None],
            b_tiles[None])
    _check(cols.dim() == 4 and b_tiles.dim() == 4,
           "expected cols/vals [G,U,R,Kmax] and b_tiles [G,nct,T,F]")
    g, u, r, kmax = cols.shape
    g2, nct, t, f = b_tiles.shape
    _check(tuple(vals.shape) == (g, u, r, kmax)
           and tuple(tile_col.shape) == (g, u)
           and tuple(unit_k.shape) == (g, u) and g2 == g,
           f"shapes differ: cols {tuple(cols.shape)}, vals "
           f"{tuple(vals.shape)}, tile_col {tuple(tile_col.shape)}, unit_k "
           f"{tuple(unit_k.shape)}, b_tiles {tuple(b_tiles.shape)}")
    _check(cols.dtype == torch.int32 and tile_col.dtype == torch.int32
           and unit_k.dtype == torch.int32 and vals.dtype == torch.float32
           and b_tiles.dtype == torch.float32,
           "expected int32 cols/tile_col/unit_k and float32 vals/B")
    for x in (cols, vals, tile_col, unit_k, b_tiles):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}")
    if dev.type == "cpu":
        out = ragged_ell_spmm_ref(cols, vals, tile_col, unit_k, b_tiles)
        return out if grouped else out[0]

    for x in (cols, vals, tile_col, unit_k, b_tiles):
        _check(x.is_contiguous(), "CUDA kernel needs contiguous tensors")
    out = torch.empty((g, u, r, f), dtype=torch.float32, device=dev)
    if g and u and r and f:
        lib, fn = _kernel()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(cols.data_ptr(), vals.data_ptr(), tile_col.data_ptr(),
                     unit_k.data_ptr(), b_tiles.data_ptr(), out.data_ptr(),
                     g, u, r, kmax, nct, t, f, stream)
        _build.check(lib, err, "ragged_ell_spmm launch")
        global launches
        launches += 1
    return out if grouped else out[0]


def _fixed_kernel():
    global _fixed_fn
    if _fixed_fn is None:
        lib = _build.library("ell_spmm")
        fn = lib.ell_spmm_f32
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 5 + [ctypes.c_void_p])
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


def _check_fixed(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ell_spmm: {msg}")


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, tile_col: torch.Tensor,
             b_tiles: torch.Tensor, *, out: torch.Tensor = None,
             device="cuda") -> torch.Tensor:
    """Per-unit ELL products of one fixed-K bucket.

    cols [(G,) U, R, K] int32 (tile-local), vals [(G,) U, R, K] f32,
    tile_col [(G,) U] int32, b_tiles [(G,) nct, T, F] f32 -> [(G,) U, R,
    F] f32; one launch for the whole group. ``cols``/``vals`` may be
    views of the ragged [.., Kmax] slab (``ell_buckets``): the kernel
    reads them with their strides, as long as the K axis is contiguous
    and both share one layout. ``out`` (optional) is where the products
    go, e.g. a unit slice of the dispatch's [G, U_all, R, F] buffer; its
    unit, row and feature axes must be contiguous. Every tensor must lie
    on ``device``; CPU tensors take the plain version, CUDA tensors
    launch the kernel or raise. Indices must be in range (``cols < T``,
    ``tile_col < nct``).
    """
    dev = resolve_device(device)
    grouped = cols.dim() == 4
    if not grouped:
        cols, vals, tile_col, b_tiles = (cols[None], vals[None],
                                         tile_col[None], b_tiles[None])
        out = None if out is None else out[None]
    _check_fixed(cols.dim() == 4 and b_tiles.dim() == 4,
                 "expected cols/vals [G,U,R,K] and b_tiles [G,nct,T,F]")
    g, u, r, k = cols.shape
    g2, nct, t, f = b_tiles.shape
    _check_fixed(tuple(vals.shape) == (g, u, r, k)
                 and tuple(tile_col.shape) == (g, u) and g2 == g,
                 f"shapes differ: cols {tuple(cols.shape)}, vals "
                 f"{tuple(vals.shape)}, tile_col {tuple(tile_col.shape)}, "
                 f"b_tiles {tuple(b_tiles.shape)}")
    _check_fixed(cols.dtype == torch.int32 and tile_col.dtype == torch.int32
                 and vals.dtype == torch.float32
                 and b_tiles.dtype == torch.float32,
                 "expected int32 cols/tile_col and float32 vals/B")
    _check_fixed(out is None or (tuple(out.shape) == (g, u, r, f)
                                 and out.dtype == torch.float32),
                 f"out must be float32 {(g, u, r, f)}")
    for x in (cols, vals, tile_col, b_tiles) + (() if out is None
                                                else (out,)):
        _check_fixed(x.device == dev, f"tensor on {x.device}, device={dev}")
    if dev.type == "cpu":
        res = ell_spmm_ref(cols, vals, tile_col, b_tiles)
        if out is not None:
            res = out.copy_(res)
        return res if grouped else res[0]

    _check_fixed(cols.stride() == vals.stride() and _packed(cols, 3)
                 and _packed(tile_col, 1) and b_tiles.is_contiguous(),
                 "CUDA kernel needs a contiguous K axis shared by cols and "
                 "vals, a contiguous tile_col unit axis and contiguous B")
    if out is None:
        out = torch.empty((g, u, r, f), dtype=torch.float32, device=dev)
    _check_fixed(_packed(out, 1),
                 "out needs contiguous unit, row and feature axes")
    if g and u and r and f:
        lib, fn = _fixed_kernel()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(cols.data_ptr(), vals.data_ptr(), tile_col.data_ptr(),
                     b_tiles.data_ptr(), out.data_ptr(), g, u, r, k, nct, t,
                     f, cols.stride(0), cols.stride(1), cols.stride(2),
                     tile_col.stride(0), out.stride(0), stream)
        _build.check(lib, err, "ell_spmm launch")
        global fixed_k_launches
        fixed_k_launches += 1
    return out if grouped else out[0]
