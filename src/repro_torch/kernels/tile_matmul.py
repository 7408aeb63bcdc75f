"""Dense tiled matmul: C = A @ B, the dense systolic array.

Port of ``repro.kernels.tile_matmul`` (the TPU kernel ``_matmul_kernel``
/ ``tile_matmul``). On CUDA tensors ``tile_matmul`` launches the
hand-written kernel in ``csrc/tile_matmul.cu``; on CPU tensors it runs
the plain version, ``repro_torch.kernels.ref.tile_matmul_ref``. Any M,
K and N work: the kernel masks the edges, which computes what the
reference's zero padding computes.

The kernel has three block configurations (``CONFIGS``), all built on
the FFMA mainloop of ``csrc/ffma_tile.cuh``: "wide" (64 x 128 output
block), "fill" (32 x 128, twice the blocks, for an M too small to fill
the card with wide blocks) and "narrow" (64 x 8, one row per thread, for
N <= 16). Long K is split across a thread-block cluster at points that
depend on K alone, and the partial sums are added in a fixed order, so
every configuration gives the same bits. ``config=None`` picks by shape
(``pick_config``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device

from . import _build
from .ref import tile_matmul_ref

CONFIGS = ("wide", "fill", "narrow")
WIDE_BM, WIDE_BN = 64, 128     # the "wide" configuration's output block

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


def pick_config(m: int, n: int, n_sms: int) -> str:
    """"narrow" for N <= 16; else "wide" when its blocks fill the card's
    ``n_sms`` SMs twice over, and "fill" (half-height blocks) when not."""
    if n <= 16:
        return "narrow"
    wide_blocks = -(-m // WIDE_BM) * -(-n // WIDE_BN)
    return "wide" if wide_blocks >= 2 * n_sms else "fill"


def tile_matmul(a: torch.Tensor, b: torch.Tensor, *, config: str = None,
                device="cuda") -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] with a float32 accumulator, in A's dtype.

    ``config`` is the kernel's block configuration (one of ``CONFIGS``;
    ``None`` picks by shape). Both tensors must lie on ``device``. CPU
    tensors take the plain version; CUDA tensors must be contiguous
    float32 and launch the kernel or raise.
    """
    dev = resolve_device(device)
    _check(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
           f"expected A [M,K] and B [K,N], got {tuple(a.shape)} and "
           f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    _check(config is None or config in CONFIGS,
           f"configuration {config!r} is not one of {CONFIGS}")
    for x in (a, b):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}")
    if dev.type == "cpu":
        return tile_matmul_ref(a, b)

    _check(a.dtype == torch.float32 and b.dtype == torch.float32,
           "the CUDA kernel takes float32 A and B")
    _check(a.is_contiguous() and b.is_contiguous(),
           "CUDA kernel needs contiguous tensors")
    if config is None:
        config = pick_config(m, n, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m and n:
        lib, fn = _kernel()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                     CONFIGS.index(config), stream)
        _build.check(lib, err, "tile_matmul launch")
        global launches
        launches += 1
    return out
