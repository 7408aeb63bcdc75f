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

bfloat16 A and B (the reference's other type) run the Hopper
tensor-core instances (``csrc/wgmma_tile.cuh``: wgmma m64nNk16 products
with a float32 accumulator, A's rows copied asynchronously at any
alignment, C rounded to bfloat16 once) in three configurations of their
own (``WG_TILES``: 128 x 128, 64 x 128 and 64 x 8 blocks under the same
names). Their K is split across a cluster at points that depend on K
alone (``wg_split_k``), so every configuration gives the same bits
there too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device

from . import _build
from .ref import tile_matmul_ref

CONFIGS = ("wide", "fill", "narrow")
WIDE_BM, WIDE_BN = 64, 128     # the "wide" configuration's output block
# Each configuration's ffma_tile::Tile<BM, BN, BK, TM, TN, STAGES>, as
# csrc/tile_matmul.cu instantiates it (for ``matmul_contract``).
TILES = {"wide": (64, 128, 16, 8, 8, 4), "fill": (32, 128, 32, 8, 4, 3),
         "narrow": (64, 8, 32, 1, 4, 4)}
# Each configuration's wgmma_tile::Tile<BM, BN, BK, STAGES>, the bfloat16
# instances of csrc/tile_matmul.cu (BM / 64 warpgroups of 128 threads).
WG_TILES = {"wide": (128, 128, 64, 4), "fill": (64, 128, 64, 3),
            "narrow": (64, 8, 64, 4)}
MAX_SPLITS, SPLIT_ALIGN = 4, 32
# The bfloat16 instances' split-K (csrc/tile_matmul.cu ``wg_split_k``).
WG_SPLIT_K, WG_SPLIT_ALIGN, WG_MAX_SPLITS = 576, 64, 3

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts),
# by the operands' type.
launches = {"float32": 0, "bfloat16": 0}

_fns: dict = {}


def _kernel(dtype: torch.dtype):
    """(library, C entry) of the kernel instances for ``dtype``."""
    name = _build.dtype_name(dtype)
    if name not in _fns:
        lib = _build.library("tile_matmul")
        fn = (lib.tile_matmul_f32 if name == "float32"
              else lib.tile_matmul_bf16)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = (lib, fn)
    return _fns[name]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"tile_matmul: {msg}")


def pick_config(m: int, n: int, n_sms: int, dtype=torch.float32) -> str:
    """"narrow" for N <= 16. Else, float32: "wide" when its blocks fill
    the card's ``n_sms`` SMs twice over, and "fill" (half-height blocks)
    when not; bfloat16: "fill" (64-row blocks, two an SM; on the H100 it
    beat "wide" at every layer-1 shape of the three graphs)."""
    if n <= 16:
        return "narrow"
    if _build.dtype_name(dtype) == "bfloat16":
        return "fill"
    wide_blocks = -(-m // WIDE_BM) * -(-n // WIDE_BN)
    return "wide" if wide_blocks >= 2 * n_sms else "fill"


def split_k(k: int) -> int:
    """Elements of k per split (csrc/tile_matmul.cu ``split_k``)."""
    splits = min(max((k + 384) // 768, 1), MAX_SPLITS)
    per = -(-k // splits)
    return -(-per // SPLIT_ALIGN) * SPLIT_ALIGN


def wg_split_k(k: int) -> int:
    """Elements of k per split of the bfloat16 instances
    (csrc/tile_matmul.cu ``wg_split_k``): a function of K alone."""
    splits = min(max((k + WG_SPLIT_K // 2) // WG_SPLIT_K, 1), WG_MAX_SPLITS)
    per = -(-k // splits)
    return -(-per // WG_SPLIT_ALIGN) * WG_SPLIT_ALIGN


def wg_splits(k: int) -> int:
    """The bfloat16 instances' K splits: the cluster's blocks on z."""
    return -(-k // wg_split_k(k)) if k > 0 else 1


def wg_smem(config: str, staged: bool) -> int:
    """Dynamic shared memory of a bfloat16 instance: ``STAGES`` ring
    slots of B's chunk, A's spans (BK/8 + 1 chunks of 16 bytes a row)
    and, where B goes through spans, B's spans; an mbarrier a slot; 1024
    bytes that align the ring to the swizzle's period."""
    bm, bn, bk, stages = WG_TILES[config]
    slot = bk * bn * 2 + bm * (bk // 8 + 1) * 16
    slot += bk * (bn // 8 + 1) * 16 if staged else 0
    return stages * slot + 8 * stages + 1024


def wg_tma(config: str, k: int, n: int, b_aligned: bool = True) -> bool:
    """Whether B's chunks arrive by TMA: 128-column blocks,
    16-byte-aligned rows (N % 8 == 0, an aligned base) and at least one
    box of each dimension; else B's rows go through spans."""
    bn, bk = WG_TILES[config][1:3]
    return bn == 128 and n % 8 == 0 and n >= 64 and k >= bk and b_aligned


def matmul_contract(m: int, k: int, n: int, *, config: str = None,
                    n_sms: int = 132, dtype=torch.float32,
                    b_aligned: bool = True) -> dict:
    """The launch contract of one ``tile_matmul`` launch: grid (M blocks,
    N blocks, K splits), the cluster (the splits of one output block),
    ``threads``, dynamic shared memory (the cp.async ring, above 48 KiB
    only with the opt-in attribute, which the launch sets), the extents
    passed as 32-bit ints, and the kernel instance's ptxas name prefix.
    ``config`` None picks as the wrapper does on a card of ``n_sms``
    SMs (132: the H100 SXM). ``dtype`` (float32 or bfloat16) is A's and
    B's: bfloat16 runs the wgmma instances (``WG_TILES``, split at
    ``wg_split_k``), whose B arrives by TMA where ``wg_tma`` holds
    (``b_aligned``: B's base is 16-byte aligned), else through spans."""
    config = config or pick_config(m, n, n_sms, dtype)
    shapes = {"a": (m, k), "b": (k, n), "c": (m, n)}
    if _build.dtype_name(dtype) == "bfloat16":
        bm, bn = WG_TILES[config][:2]
        tma = wg_tma(config, k, n, b_aligned)
        splits = wg_splits(k)
        return dict(
            name="tile_matmul", source="tile_matmul",
            kernel="wgmma_matmul_kernel", config=config,
            instance=WG_TILES[config], dtype="bfloat16", tma=tma,
            split_k=wg_split_k(k) if k > 0 else 1,
            ptxas_name="wgmma_matmul_kernelIN10wgmma_tile4Tile"
            + _build.mangled_args(WG_TILES[config]) + f"ELb{int(tma)}E",
            threads=128 * (bm // 64),
            grid=(max(-(-m // bm), 1), max(-(-n // bn), 1), splits),
            cluster=(1, 1, splits), dyn_smem=wg_smem(config, not tma),
            static_smem=0, smem_optin=True, shapes=shapes,
            extents={"M": m, "N": n, "K": k}, index_bounds={})
    bm, bn, bk, tm, tn, stages = TILES[config]
    splits = -(-k // split_k(k)) if k > 0 else 1
    return dict(
        name="tile_matmul", source="tile_matmul", kernel="matmul_kernel",
        config=config, instance=TILES[config], dtype="float32",
        ptxas_name="matmul_kernelIN9ffma_tile4Tile"
        + _build.mangled_args(TILES[config]) + "E",
        threads=(bm // tm) * (bn // tn),
        grid=(max(-(-m // bm), 1), max(-(-n // bn), 1), splits),
        cluster=(1, 1, splits),
        dyn_smem=stages * (bm * (bk + 4) + bk * bn) * 4, static_smem=0,
        smem_optin=True, shapes=shapes,
        extents={"M": m, "N": n, "K": k}, index_bounds={})


def tile_matmul(a: torch.Tensor, b: torch.Tensor, *, config: str = None,
                out: torch.Tensor = None, device="cuda") -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] with a float32 accumulator, in A's dtype.

    ``config`` is the kernel's block configuration (one of ``CONFIGS``;
    ``None`` picks by shape). ``out``: a contiguous [M,N] tensor of A's
    dtype on ``device`` to write C into (at any alignment), else a new
    one. Both tensors must lie on ``device``. CPU tensors take the plain
    version; CUDA tensors must be contiguous and both float32 or both
    bfloat16, and launch the kernel or raise.
    """
    _build.tick("tile_matmul")
    dev = resolve_device(device)
    _check(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
           f"expected A [M,K] and B [K,N], got {tuple(a.shape)} and "
           f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    _check(config is None or config in CONFIGS,
           f"configuration {config!r} is not one of {CONFIGS}")
    for x in (a, b) if out is None else (a, b, out):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}")
    if out is not None:
        _check(tuple(out.shape) == (m, n) and out.dtype == a.dtype
               and out.is_contiguous(),
               f"out must be a contiguous ({m}, {n}) {a.dtype} tensor, got "
               f"{tuple(out.shape)} {out.dtype}")
    if dev.type == "cpu":
        c = tile_matmul_ref(a, b)
        return c if out is None else out.copy_(c)

    _check(a.dtype == b.dtype and a.dtype in _build.DTYPES,
           "the CUDA kernel takes float32 or bfloat16 A and B of one type, "
           f"got {a.dtype} and {b.dtype}")
    _check(a.is_contiguous() and b.is_contiguous(),
           "CUDA kernel needs contiguous tensors")
    if config is None:
        config = pick_config(m, n, torch.cuda.get_device_properties(
            dev).multi_processor_count, a.dtype)
    if out is None:
        out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if m and n:
        lib, fn = _kernel(a.dtype)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                     CONFIGS.index(config), stream)
        _build.check(lib, err, "tile_matmul launch")
        with _build.count_lock:
            launches[_build.dtype_name(a.dtype)] += 1
    return out
