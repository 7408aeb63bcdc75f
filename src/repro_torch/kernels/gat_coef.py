"""GAT edge coefficients: each row's softmax statistics over all its
neighbours, then the coefficient of every stored entry of each engine's
layout, per head (``csrc/gat_coef.cu``).

A graph attention layer weighs edge (i, j) of head h by
``softmax_j(LeakyReLU(s_i + t_j))`` over i's neighbours in A + I. The
tri-partition splits a row's neighbours over up to three engines, so the
row's maximum and denominator are taken here once, over the row's
neighbour list (``gat_row_stats``), and every engine's entries get the
same ``exp(LeakyReLU(s_i + t_j) - m_i)`` (``gat_edge_coef``); the layer's
epilogue divides the engines' summed rows by the denominator. No TPU
kernel corresponds: the reference serves the GCN alone.

Both functions launch their kernel on CUDA tensors, one launch for a
whole group, and run their plain versions (``repro_torch.kernels.ref``
``gat_row_stats_ref`` / ``gat_edge_coef_ref``) on CPU tensors. Float32
throughout.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device

from . import _build
from .ref import gat_edge_coef_ref, gat_row_stats_ref

SOURCE = "gat_coef"
STATS_KERNEL = "gat_row_stats_kernel"
COEF_KERNEL = "gat_edge_coef_kernel"
THREADS = 256           # threads per block of both kernels

# Launches since the last reset (``reset_launch_counts``), by kernel.
launches = {"row_stats": 0, "edge_coef": 0}

_fns: dict = {}


def reset_launch_counts() -> None:
    with _build.count_lock:
        for k in launches:
            launches[k] = 0


def _kernel(entry: str, argtypes: list):
    if entry not in _fns:
        lib = _build.library(SOURCE)
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[entry] = (lib, fn)
    return _fns[entry]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gat_coef: {msg}")


def row_stats_contract(rows: int, h: int) -> dict:
    """The launch contract of one ``gat_row_stats`` launch over ``rows``
    rows (G * P) and ``h`` heads: a warp a row, ``THREADS`` a block."""
    per = THREADS // 32
    return dict(name="gat_row_stats", source=SOURCE, kernel=STATS_KERNEL,
                instance=(h,), threads=THREADS,
                grid=(max(-(-rows // per), 1), 1, 1), dyn_smem=0,
                static_smem=0, smem_optin=False,
                ptxas_name=STATS_KERNEL + _build.mangled_args((h,)),
                extents={"rows": rows}, index_bounds={}, shapes={})


def edge_coef_contract(slots: int, h: int) -> dict:
    """The launch contract of one ``gat_edge_coef`` launch over ``slots``
    slots of the three layouts (the group's) and ``h`` heads."""
    return dict(name="gat_edge_coef", source=SOURCE, kernel=COEF_KERNEL,
                instance=(h,), threads=THREADS,
                grid=(max(-(-slots // THREADS), 1), 1, 1), dyn_smem=0,
                static_smem=0, smem_optin=False,
                ptxas_name=COEF_KERNEL + _build.mangled_args((h,)),
                extents={"slots": slots}, index_bounds={}, shapes={})


def row_stats_work(n_rows: int, nnz: int, h: int) -> tuple:
    """(bytes, FLOPs) the row statistics need whatever computes them: the
    neighbour lists' column indices (4 bytes each) and row pointers (8)
    once, s and t once per node and head, one maximum and one denominator
    written per row and head; about five operations per stored entry and
    head (the max, the add, LeakyReLU, the subtraction, the exponential's
    share and the sum counted as five)."""
    nbytes = 4 * nnz + 8 * (n_rows + 1) + 4 * 2 * n_rows * h \
        + 4 * 2 * n_rows * h
    return float(nbytes), 5.0 * nnz * h


def gat_row_stats(offsets: torch.Tensor, cols: torch.Tensor,
                  s: torch.Tensor, t: torch.Tensor, slope: float, *,
                  device="cuda") -> tuple:
    """Each row's softmax statistics, per head: (m, d) [G, P, H] f32.

    ``offsets`` [G * P + 1] int64 and ``cols`` [E] int32 are the rows'
    neighbour lists (row g*P + i's are ``cols[offsets[g*P+i] :
    offsets[g*P+i+1]]``, columns of member g), ``s`` [G, P, H] f32 the
    rows' scores, ``t`` [G, N, H] f32 the columns'. ``m`` =
    LeakyReLU(s_i + max_j t_j) (the row's largest LeakyReLU(s_i + t_j)),
    ``d`` = sum_j exp(LeakyReLU(s_i + t_j) - m); a row without a
    neighbour reads 0 and 0. CPU tensors take the plain version."""
    _build.tick("gat_row_stats")
    dev = resolve_device(device)
    _check(s.dim() == 3 and t.dim() == 3 and s.shape[0] == t.shape[0]
           and s.shape[2] == t.shape[2], f"s {tuple(s.shape)} and t "
           f"{tuple(t.shape)}: want [G, P, H] and [G, N, H]")
    g, p, h = s.shape
    _check(tuple(offsets.shape) == (g * p + 1,) and cols.dim() == 1,
           f"offsets {tuple(offsets.shape)} for {g * p} rows")
    _check(offsets.dtype == torch.int64 and cols.dtype == torch.int32
           and s.dtype == t.dtype == torch.float32,
           "expected int64 offsets, int32 cols and float32 scores")
    for x in (offsets, cols, s, t):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}")
    if dev.type == "cpu":
        return gat_row_stats_ref(offsets, cols, s, t, slope)
    _check(h in _build.HEADS,
           f"{h} heads: the kernel is built for {_build.HEADS}")
    for x in (offsets, cols, s, t):
        _check(x.is_contiguous(), "CUDA kernel needs contiguous tensors")
    m = torch.empty_like(s)
    d = torch.empty_like(s)
    if g * p == 0:
        return m, d
    lib, fn = _kernel("gat_row_stats_f32",
                      [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                               ctypes.c_int,
                                               ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_float,
                                               ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(offsets.data_ptr(), cols.data_ptr(), s.data_ptr(),
                 t.data_ptr(), m.data_ptr(), d.data_ptr(), g * p, p,
                 t.shape[1], h, float(slope), stream)
    _build.check(lib, err, "gat_row_stats launch")
    with _build.count_lock:
        launches["row_stats"] += 1
    return m, d


def gat_edge_coef(part, s: torch.Tensor, t: torch.Tensor, m: torch.Tensor,
                  slope: float, tile: int, *, device="cuda") -> tuple:
    """The unnormalised coefficient exp(LeakyReLU(s_i + t_j) - m_i) of
    every stored entry of each engine's layout, per head; +0 where a
    layout's value is 0 (no entry there).

    ``part`` is a grouped ``TriPartition`` of the graph's pattern (float32
    values), ``s``/``m`` [G, P, H] and ``t`` [G, N, H] f32, ``tile`` T.
    Returns (dense [G, n_t, H, T, T], ell [G, U, R, Kmax, H], coo
    [G, nnz, H]) f32, the values the multi-head engines read. One launch
    covers the three layouts and the group; CPU tensors take the plain
    version."""
    _build.tick("gat_edge_coef")
    dev = resolve_device(device)
    g, p, h = s.shape
    _check(tuple(m.shape) == (g, p, h) and t.dim() == 3 and t.shape[0] == g
           and t.shape[2] == h, f"s {tuple(s.shape)}, t {tuple(t.shape)}, "
           f"m {tuple(m.shape)}")
    dt, el, co = part
    _check(dt.tiles.dim() == 4 and el.cols.dim() == 4 and co.vals.dim() == 2,
           "expected a grouped partition")
    for x in (s, t, m, dt.tiles, el.vals, co.vals):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}")
        _check(x.dtype == torch.float32, "float32 scores and values")
    if dev.type == "cpu":
        return gat_edge_coef_ref(part, s, t, m, slope, tile)
    _check(h in _build.HEADS,
           f"{h} heads: the kernel is built for {_build.HEADS}")
    n_t = dt.tiles.shape[1]
    _, u, r, k = el.cols.shape
    nnz = co.vals.shape[1]
    dense = torch.empty((g, n_t, h, tile, tile), dtype=torch.float32,
                        device=dev)
    ell = torch.empty((g, u, r, k, h), dtype=torch.float32, device=dev)
    coo = torch.empty((g, nnz, h), dtype=torch.float32, device=dev)
    leaves = (dt.tiles, dt.tile_row, dt.tile_col, el.vals, el.cols, el.rows,
              el.tile_col, co.vals, co.rows, co.cols, s, t, m)
    for x in leaves:
        _check(x.is_contiguous(), "CUDA kernel needs contiguous tensors")
    if g * (n_t * tile * tile + u * r * k + nnz) == 0:
        return dense, ell, coo
    lib, fn = _kernel("gat_edge_coef_f32",
                      [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                      + [ctypes.c_void_p] * 4
                      + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                      + [ctypes.c_void_p] * 3
                      + [ctypes.c_longlong, ctypes.c_int]
                      + [ctypes.c_void_p] * 6
                      + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dt.tiles.data_ptr(), dt.tile_row.data_ptr(),
                 dt.tile_col.data_ptr(), n_t, el.vals.data_ptr(),
                 el.cols.data_ptr(), el.rows.data_ptr(),
                 el.tile_col.data_ptr(), u, r, k, co.vals.data_ptr(),
                 co.rows.data_ptr(), co.cols.data_ptr(), nnz, tile,
                 s.data_ptr(), t.data_ptr(), m.data_ptr(), dense.data_ptr(),
                 ell.data_ptr(), coo.data_ptr(), g, p, t.shape[1], h,
                 float(slope), stream)
    _build.check(lib, err, "gat_edge_coef launch")
    with _build.count_lock:
        launches["edge_coef"] += 1
    return dense, ell, coo
