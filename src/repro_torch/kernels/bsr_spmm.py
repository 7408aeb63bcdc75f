"""Dense-tile engine: a BSR stack of T×T tiles times tile-sliced B.

Port of ``repro.kernels.bsr_spmm`` (the TPU kernel ``_bsr_kernel`` /
``bsr_spmm``). On CUDA tensors ``bsr_spmm`` launches the hand-written
kernel in ``csrc/bsr_spmm.cu`` (one launch for a whole group, the group
axis ``G`` is a grid dimension); on CPU tensors it runs the plain
version, ``repro_torch.kernels.ref.bsr_spmm_ref``. The caller sums the
per-tile products over ``tile_row``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device

from . import _build
from .ref import bsr_spmm_ref

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts).
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("bsr_spmm")
        fn = lib.bsr_spmm_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"bsr_spmm: {msg}")


def bsr_spmm(tiles: torch.Tensor, tile_col: torch.Tensor,
             b_tiles: torch.Tensor, *, device="cuda") -> torch.Tensor:
    """tiles [(G,) n_t, T, T] f32, tile_col [(G,) n_t] int32,
    b_tiles [(G,) nct, T, F] f32 -> [(G,) n_t, T, F] f32 per-tile products.

    Every tensor must lie on ``device``. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.
    """
    dev = resolve_device(device)
    grouped = tiles.dim() == 4
    if not grouped:
        tiles, tile_col, b_tiles = tiles[None], tile_col[None], b_tiles[None]
    _check(tiles.dim() == 4 and tile_col.dim() == 2 and b_tiles.dim() == 4,
           "expected tiles [G,n_t,T,T], tile_col [G,n_t], b_tiles "
           "[G,nct,T,F]")
    g, n_t, t, t2 = tiles.shape
    g2, nct, t3, f = b_tiles.shape
    _check(t == t2 == t3, f"tile edges differ: {t}, {t2}, {t3}")
    _check(g == g2 and tuple(tile_col.shape) == (g, n_t),
           f"group/tile counts differ: {tuple(tiles.shape)}, "
           f"{tuple(tile_col.shape)}, {tuple(b_tiles.shape)}")
    _check(tiles.dtype == torch.float32 and b_tiles.dtype == torch.float32
           and tile_col.dtype == torch.int32, "expected float32 tiles/B and "
           "int32 tile_col")
    for x in (tiles, tile_col, b_tiles):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}")
    if dev.type == "cpu":
        out = bsr_spmm_ref(tiles, tile_col, b_tiles)
        return out if grouped else out[0]

    for x in (tiles, tile_col, b_tiles):
        _check(x.is_contiguous(), "CUDA kernel needs contiguous tensors")
    out = torch.empty((g, n_t, t, f), dtype=torch.float32, device=dev)
    if g and n_t and f:
        lib, fn = _kernel()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(tiles.data_ptr(), tile_col.data_ptr(),
                     b_tiles.data_ptr(), out.data_ptr(), g, n_t, nct, t, f,
                     stream)
        _build.check(lib, err, "bsr_spmm launch")
        global launches
        launches += 1
    return out if grouped else out[0]
