"""Dense-tile engine: a BSR stack of T×T tiles times tile-sliced B.

Port of ``repro.kernels.bsr_spmm`` (the TPU kernel ``_bsr_kernel`` /
``bsr_spmm``) and of the sum over ``tile_row`` that the reference's
``dense_tiles_matmul`` applies to its products. Both functions launch
the one hand-written kernel in ``csrc/bsr_spmm.cu`` on CUDA tensors
(one launch for a whole group: the group axis ``G`` is a grid
dimension) and run their plain versions from
``repro_torch.kernels.ref`` on CPU tensors:

  * ``bsr_spmm_rows`` — the dense engine as the main path runs it: the
    products summed per row tile inside the kernel, in the order of the
    dense ``SegmentPlan``;
  * ``bsr_spmm`` — the reference's per-tile products, the same kernel
    with every tile its own segment.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import SegmentPlan
from repro_torch.device import resolve_device

from . import _build
from .ref import bsr_spmm_ref, bsr_spmm_rows_ref

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts).
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("bsr_spmm")
        fn = lib.bsr_spmm_rows_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"bsr_spmm: {msg}")


def _checked(tiles, tile_col, b_tiles, dev) -> tuple:
    """The inputs with a group axis, after the checks both functions
    share; (tiles, tile_col, b_tiles, grouped)."""
    grouped = tiles.dim() == 4
    if not grouped:
        tiles, tile_col, b_tiles = tiles[None], tile_col[None], b_tiles[None]
    _check(tiles.dim() == 4 and tile_col.dim() == 2 and b_tiles.dim() == 4,
           "expected tiles [G,n_t,T,T], tile_col [G,n_t], b_tiles "
           "[G,nct,T,F]")
    g, n_t, t, t2 = tiles.shape
    g2, _, t3, _ = b_tiles.shape
    _check(t == t2 == t3, f"tile edges differ: {t}, {t2}, {t3}")
    _check(g == g2 and tuple(tile_col.shape) == (g, n_t),
           f"group/tile counts differ: {tuple(tiles.shape)}, "
           f"{tuple(tile_col.shape)}, {tuple(b_tiles.shape)}")
    _check(tiles.dtype == torch.float32 and b_tiles.dtype == torch.float32
           and tile_col.dtype == torch.int32, "expected float32 tiles/B and "
           "int32 tile_col")
    for x in (tiles, tile_col, b_tiles):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}")
        _check(dev.type == "cpu" or x.is_contiguous(),
               "CUDA kernel needs contiguous tensors")
    return tiles, tile_col, b_tiles, grouped


def _launch(tiles, tile_col, b_tiles, order, offsets, n_rt, dev):
    """One kernel launch; ``order``/``offsets`` None = per-tile."""
    g, _, t, _ = tiles.shape
    nct, f = b_tiles.shape[1], b_tiles.shape[3]
    out = torch.empty((g, n_rt, t, f), dtype=torch.float32, device=dev)
    if g and n_rt and f:
        lib, fn = _kernel()
        ptr = (lambda x: None if x is None else x.data_ptr())  # noqa: E731
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(tiles.data_ptr(), tile_col.data_ptr(),
                     b_tiles.data_ptr(), ptr(order), ptr(offsets),
                     out.data_ptr(), g, n_rt, nct, t, f, stream)
        _build.check(lib, err, "bsr_spmm launch")
        global launches
        with _build.count_lock:
            launches += 1
    return out


def bsr_spmm_rows(tiles: torch.Tensor, tile_col: torch.Tensor,
                  b_tiles: torch.Tensor, plan: SegmentPlan, *,
                  device="cuda") -> torch.Tensor:
    """tiles [G, n_t, T, T] f32, tile_col [G, n_t] int32, b_tiles
    [G, nct, T, F] f32 and the dense ``plan`` (entries ``g*n_t + i``
    onto segments ``g*n_rt + tile_row``) -> [G, n_rt, T, F] f32: each
    row tile's products summed in plan order, zeros where it has none.

    Every tensor must lie on ``device``. CPU tensors take the plain version
    (``bsr_spmm_ref`` then ``segment_sum``); CUDA tensors launch the
    kernel or raise. A partition with no dense tile (``n_t == 0``), or a
    plan with no entry, gives zeros without a launch, as the plain
    version does: the kernel refuses an empty plan's null ``order``.
    """
    dev = resolve_device(device)
    tiles, tile_col, b_tiles, _ = _checked(tiles, tile_col, b_tiles, dev)
    g = tiles.shape[0]
    n_seg = plan.lengths.shape[0]
    _check(g > 0 and n_seg % g == 0,
           f"{n_seg} segments do not split over {g} members")
    _check(plan.order.device == dev and plan.lengths.device == dev,
           f"plan on {plan.order.device}, device={dev}")
    if dev.type == "cpu":
        return bsr_spmm_rows_ref(tiles, tile_col, b_tiles, plan)
    for x in (plan.order, plan.offsets):
        _check(x.dtype == torch.int64 and x.is_contiguous()
               and x.device == dev, "plan order/offsets must be contiguous "
               f"int64 on {dev}")
    _check(plan.offsets.shape[0] == n_seg + 1, f"{plan.offsets.shape[0]} "
           f"offsets for {n_seg} segments")
    if tiles.shape[1] == 0 or plan.order.shape[0] == 0:
        return torch.zeros((g, n_seg // g, tiles.shape[2], b_tiles.shape[3]),
                           dtype=torch.float32, device=dev)
    return _launch(tiles, tile_col, b_tiles, plan.order, plan.offsets,
                   n_seg // g, dev)


def bsr_spmm(tiles: torch.Tensor, tile_col: torch.Tensor,
             b_tiles: torch.Tensor, *, device="cuda") -> torch.Tensor:
    """tiles [(G,) n_t, T, T] f32, tile_col [(G,) n_t] int32,
    b_tiles [(G,) nct, T, F] f32 -> [(G,) n_t, T, F] f32 per-tile products.

    Every tensor must lie on ``device``. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.
    """
    dev = resolve_device(device)
    tiles, tile_col, b_tiles, grouped = _checked(tiles, tile_col, b_tiles,
                                                 dev)
    if dev.type == "cpu":
        out = bsr_spmm_ref(tiles, tile_col, b_tiles)
    else:
        out = _launch(tiles, tile_col, b_tiles, None, None, tiles.shape[1],
                      dev)
    return out if grouped else out[0]
