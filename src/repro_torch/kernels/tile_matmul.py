"""Dense tiled matmul: C = A @ B, the dense systolic array.

Port of ``repro.kernels.tile_matmul`` (the TPU kernel ``_matmul_kernel``
/ ``tile_matmul``). On CUDA tensors ``tile_matmul`` launches the
hand-written kernel in ``csrc/tile_matmul.cu``; on CPU tensors it runs
the plain version, ``repro_torch.kernels.ref.tile_matmul_ref``. Any M,
K and N work: the kernel masks the edges, which computes what the
reference's zero padding computes.

The Hopper kernel's output block is ``BM`` x ``bn``: 256 threads per
block, each accumulating a (BM/16) x (bn/16) register micro-tile, with K
walked in chunks of 32 staged in shared memory. ``BM`` is 64. The knob
``bn`` is 64 or 16 and defaults to 16 for N <= 16 (the GCN's layer-2
widths of 3-7 would leave most of a 64-wide tile idle) and to 64
otherwise. Both widths give the same bits: each output element is one
FMA chain in ascending k.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device

from . import _build
from .ref import tile_matmul_ref

BM = 64
BLOCK_NS = (64, 16)

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts).
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("tile_matmul")
        fn = lib.tile_matmul_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"tile_matmul: {msg}")


def tile_matmul(a: torch.Tensor, b: torch.Tensor, *, bn: int = None,
                device="cuda") -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] with a float32 accumulator, in A's dtype.

    ``bn`` is the width of the kernel's output block (one of
    ``BLOCK_NS``; ``None`` picks by N). Both tensors must lie on
    ``device``. CPU tensors take the plain version; CUDA tensors must be
    contiguous float32 and launch the kernel or raise.
    """
    dev = resolve_device(device)
    _check(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
           f"expected A [M,K] and B [K,N], got {tuple(a.shape)} and "
           f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if bn is None:
        bn = 16 if n <= 16 else 64
    _check(bn in BLOCK_NS, f"block width {bn} is not one of {BLOCK_NS}")
    for x in (a, b):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}")
    if dev.type == "cpu":
        return tile_matmul_ref(a, b)

    _check(a.dtype == torch.float32 and b.dtype == torch.float32,
           "the CUDA kernel takes float32 A and B")
    _check(a.is_contiguous() and b.is_contiguous(),
           "CUDA kernel needs contiguous tensors")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m and n:
        lib, fn = _kernel()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, bn,
                     stream)
        _build.check(lib, err, "tile_matmul launch")
        global launches
        launches += 1
    return out
