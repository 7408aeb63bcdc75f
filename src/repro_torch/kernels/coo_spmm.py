"""Flexible engine: the COO row kernel.

``coo_rows`` is the tri-partition's COO part as the port's ``cuda``
backend runs it: each entry's message ``vals[e] * B[cols[e]]``, summed
onto its output row in the order of the COO ``SegmentPlan`` and added
onto the dense and ELL engines' rows, in place, by one launch of
``csrc/coo_rows.cu`` for a whole group. The reference's flexible engine
is plain JAX (``jnp.take`` and ``jax.ops.segment_sum``), with no Pallas
kernel; its plain PyTorch version, ``repro_torch.kernels.ref
.coo_rows_ref``, is what CPU tensors run and what the kernel is held
against, bit for bit.

The kernel walks the plan's live rows longest first
(``formats.RowOrder``, built on the host with the plan). A row of at
least ``long_row(entries)`` entries, a length read from the plan's size,
takes a block for each chunk of ``w`` features, its B rows staged
through shared memory; a shorter row takes a group of ``w`` lanes
(``launch_shape``). Neither changes a sum's order, so every row gives
the same bits either way.

Types: ``vals`` and B each float32 or bfloat16, widened to float32 where
they are loaded; the messages, sums and output rows are float32.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.formats import RowOrder, SegmentPlan
from repro_torch.device import resolve_device

from . import _build
from .ell_spmm import instance_dtypes, type_suffix
from .ref import coo_rows_ref

SOURCE = "coo_rows"
KERNEL = "coo_rows_kernel"
THREADS = 256           # threads per block (csrc/coo_rows.cu kThreads)
KC = 4                  # a short row's entries in flight per lane (kKC)
LOADS = 16              # B elements a thread stages a long-row stage (kLoads)
STAGE = 512             # at most this many entries a long-row stage (kStage)
# Row groups the card holds at once: 132 SMs, 4 blocks of 256 threads
# each (the kernel's minimum), 8 rows of 32 lanes a block.
RESIDENT_ROWS = 4096
# The shortest row the long path may take.
MIN_LONG_ROW = 32
# The launch shapes (w, vec, nv) the source is built with.
SHAPES = ((8, 1, 1), (16, 1, 1), (32, 1, 1), (32, 1, 2), (32, 4, 1))
INDEX_LIMIT = 2 ** 31   # what the kernel numbers in 32 bits

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts),
# float32 instances and bfloat16 ones (vals, B or both bfloat16).
launches = {"float32": 0, "bfloat16": 0}

_fns: dict = {}


def launch_shape(f: int, aligned: bool = True) -> tuple:
    """(w, vec, nv) of the kernel instance for ``f`` features (the
    source's ``pick``): ``w`` lanes a short row and features a long row's
    chunk, ``vec`` elements a load (4 where F % 4 == 0 and B and the
    output are ``aligned``), ``nv`` loads a lane and pass."""
    if f <= 8:
        return 8, 1, 1
    if f <= 16:
        return 16, 1, 1
    if f % 4 == 0 and aligned:
        return 32, 4, 1
    return (32, 1, 1) if f <= 32 else (32, 1, 2)


def long_row(entries: int) -> int:
    """The length from which a row takes the long path, for a launch of
    ``entries`` plan entries: the entries each resident row group would
    walk were the launch spread evenly over the card (``entries /
    RESIDENT_ROWS``), down to a power of two, at least ``MIN_LONG_ROW``.
    A row past it would walk its chain on the short path longer than the
    rest of the launch takes, so it gets a block for each chunk of
    features instead."""
    share = max(int(entries) // RESIDENT_ROWS, 1)
    return max(1 << (share.bit_length() - 1), MIN_LONG_ROW)


def _grid_x(f: int, w: int, n_live: int, n_long: int) -> int:
    return n_long * -(-f // w) + -(-(n_live - n_long) // (THREADS // w))


def coo_rows_contract(g: int, nnz: int, nb: int, p: int, f: int, *,
                      n_live: int = None, n_long: int = 0,
                      aligned: bool = True, vals_dtype=torch.float32,
                      b_dtype=torch.float32) -> dict:
    """The launch contract of one ``coo_rows`` launch, for the contract
    audit: a group of ``g`` members of ``nnz`` entries each, B of ``nb``
    rows and ``f`` features a member, ``p`` output rows a member, of
    which ``n_live`` (all of them by default) have an entry and
    ``n_long`` take the long path. The keys of the ELL contracts: grid,
    ``threads``, ``w`` / ``vec`` / ``nv`` / ``kc``, the ``instance`` (w,
    vec, nv and the (vals, B) type names), shared memory (static, in the
    long path's stages), the operand ``shapes``, the ``extents`` the
    kernel numbers in 32 bits and the ``index_bounds`` (``cols < nb``)."""
    w, vec, nv = launch_shape(f, aligned)
    n_live = g * p if n_live is None else n_live
    dtypes = instance_dtypes(vals_dtype, b_dtype)
    instance = (w, vec, nv) + dtypes
    stage = min(LOADS * THREADS // w, STAGE)
    return dict(
        name="coo_rows", source=SOURCE, kernel=KERNEL, w=w, vec=vec, nv=nv,
        kc=KC, threads=THREADS, instance=instance, dtypes=dtypes,
        ptxas_name=KERNEL + _build.mangled_args(instance),
        grid=(max(_grid_x(f, w, n_live, n_long), 1), 1, 1), f=f,
        aligned16=aligned, dyn_smem=0, static_smem=4 * stage * (w + 4),
        smem_optin=False,
        shapes={"cols": (g, nnz), "vals": (g, nnz), "b": (g, nb, f),
                "out": (g, p, f), "rows": (n_live,)},
        extents={"plan entries": g * nnz, "rows": g * p,
                 "grid x": _grid_x(f, w, n_live, n_long)},
        index_bounds={"cols": nb})


def coo_rows_cost(cols: torch.Tensor, plan: SegmentPlan, f: int,
                  dtypes=("float32", "float32")) -> dict:
    """HBM bytes and operations of one ``coo_rows`` launch over this plan
    (read on the host): for each entry in the plan its order position (8
    bytes), its B row index (4) and value; each distinct (member, B row)
    those entries address, ``f`` elements of B's type; each live row's
    two offsets and its launch-order entry (8 bytes each); each live
    output row read and written (4 bytes a feature each way). Operations:
    a multiply and an add per entry and feature, one add per live row
    and feature onto the rows it adds onto."""
    nnz = cols.shape[-1]
    order = plan.order.cpu().numpy()
    live = int(np.count_nonzero(plan.lengths.cpu().numpy()))
    c = cols.cpu().numpy().reshape(-1)
    b_rows = np.unique((order // nnz) * (int(c.max(initial=0)) + 1)
                       + c[order]).size
    vb, bb = (torch.empty((), dtype=getattr(torch, d)).element_size()
              for d in dtypes)
    e = order.size
    nbytes = e * (8 + 4 + vb) + b_rows * f * bb + live * (3 * 8 + 2 * 4 * f)
    return {"hbm_bytes": float(nbytes), "flops": float(2.0 * e * f + live * f)}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"coo_rows: {msg}")


def _kernel(vals_dtype, b_dtype):
    """(library, C entry) of the instances for these types."""
    entry = f"coo_rows_{type_suffix(instance_dtypes(vals_dtype, b_dtype))}"
    if entry not in _fns:
        lib = _build.library(SOURCE)
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[entry] = (lib, fn)
    return _fns[entry]


HEADS_KERNEL = "coo_rows_heads_kernel"


def _heads_kernel():
    entry = "coo_rows_heads_f32"
    if entry not in _fns:
        lib = _build.library(SOURCE)
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[entry] = (lib, fn)
    return _fns[entry]


def heads_stage(w: int, h: int) -> int:
    """Entries of a long-row stage of the instance with ``w`` features a
    chunk and ``h`` values an entry (the source's ``fit_stage``): halved
    until the block's static shared memory fits 48 KiB."""
    e = min(LOADS * THREADS // w, STAGE)
    while h > 1 and 4 * e * (w + 2 + 2 * h) > 48 * 1024:
        e //= 2
    return e


def coo_rows_heads_contract(g: int, nnz: int, nb: int, p: int, f: int,
                            h: int, *, n_live: int = None, n_long: int = 0,
                            aligned: bool = True) -> dict:
    """The launch contract of one multi-head ``coo_rows`` launch (float32
    vals [G, nnz, H] and B): ``coo_rows_contract``'s keys at the
    instance ``launch_shape`` picks, ``vec`` 4 only where a head's F / H
    features are whole vectors, the kernel
    ``coo_rows_heads_kernel``, the instance (w, vec, nv, h), and the long
    path's shared memory with H values an entry staged."""
    c = coo_rows_contract(g, nnz, nb, p, f, n_live=n_live, n_long=n_long,
                          aligned=aligned and (f // h) % 4 == 0)
    instance = (c["w"], c["vec"], c["nv"], h)
    stage = heads_stage(c["w"], h)
    c.update(kernel=HEADS_KERNEL, instance=instance,
             ptxas_name=HEADS_KERNEL + _build.mangled_args(instance),
             static_smem=4 * stage * (c["w"] + 2 + 2 * h))
    c["shapes"] = dict(c["shapes"], vals=(g, nnz, h))
    c["extents"] = dict(c["extents"], **{"value lanes": g * nnz * h})
    return c


def coo_rows(cols: torch.Tensor, vals: torch.Tensor, b_tiles: torch.Tensor,
             plan: SegmentPlan, rows: RowOrder, out: torch.Tensor, *,
             device="cuda") -> torch.Tensor:
    """The flexible engine's rows, added onto ``out`` in place.

    cols [G, nnz] int32 (B rows), vals [G, nnz] f32 or bf16 (or
    [G, nnz, H] f32, H values an entry: feature f of B takes the value of
    its head f / (F / H), with B f32 and H in ``_build.HEADS``), b_tiles
    [G, nct, T, F] f32 or bf16 (B's rows as the ELL kernels take them,
    ``formats.b_tiles_of``), ``plan`` the COO ``SegmentPlan`` (entries
    ``g*nnz + i`` onto segments ``g*P + row``), ``rows`` its ``RowOrder``
    (``ReductionPlan.coo_rows``) and ``out`` [G, P, F] f32, which holds
    the dense and ELL engines' rows. Each row with COO entries becomes
    ``out[row] + sum of its messages vals[e] * B[cols[e]]`` (the sum in
    plan order, from +0); rows without one are not touched, which equals
    adding +0 where ``out`` holds no -0 (the engines' rows never do).
    Returns ``out``.

    Every tensor must lie on ``device``. CPU tensors take the plain
    version (``coo_rows_ref``; ``rows`` may then be None); CUDA tensors
    launch the kernel, one launch for the group, or raise. Indices must
    be in range (``cols < nct * T``): partitions guarantee it.
    """
    _build.tick("coo_rows")
    dev = resolve_device(device)
    heads = vals.dim() == 3
    h = vals.shape[-1] if heads else 1
    _check(cols.dim() == 2 and vals.dim() in (2, 3) and b_tiles.dim() == 4
           and out.dim() == 3, "expected cols [G,nnz], vals [G,nnz] (or "
           "[G,nnz,H]), b_tiles [G,nct,T,F] and out [G,P,F]")
    g, nnz = cols.shape
    _, nct, t, f = b_tiles.shape
    n_seg = plan.lengths.shape[0]
    _check(not heads or (vals.dtype == b_tiles.dtype == torch.float32
                         and f % h == 0),
           f"multi-head values: float32 vals and B, {f} columns over {h} "
           "heads")
    _check(tuple(vals.shape[:2]) == (g, nnz) and b_tiles.shape[0] == g
           and tuple(out.shape) == (g, n_seg // max(g, 1), f)
           and out.shape[0] * out.shape[1] == n_seg,
           f"shapes differ: cols {tuple(cols.shape)}, vals "
           f"{tuple(vals.shape)}, b_tiles {tuple(b_tiles.shape)}, out "
           f"{tuple(out.shape)}, {n_seg} plan segments")
    _check(cols.dtype == torch.int32 and vals.dtype in _build.DTYPES
           and b_tiles.dtype in _build.DTYPES
           and out.dtype == torch.float32, "expected int32 cols, float32 "
           f"or bfloat16 vals/B and a float32 out (got {cols.dtype}, "
           f"{vals.dtype}, {b_tiles.dtype}, {out.dtype})")
    _check(plan.n_entries == nnz, f"plan of {plan.n_entries} entries for "
           f"{nnz} a member")
    for x in (cols, vals, b_tiles, out, plan.order, plan.lengths):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}")
    if dev.type == "cpu":
        return coo_rows_ref(cols, vals, b_tiles.reshape(g, nct * t, f), plan,
                            out)
    _check(rows is not None, "the plan has no row order (coo_rows): build "
           "it with reduction_plan or stack_plans")
    for x in (cols, vals, b_tiles, out):
        _check(x.is_contiguous(), "CUDA kernel needs contiguous tensors")
    for x in (plan.order, plan.offsets, rows.rows):
        _check(x.dtype == torch.int64 and x.is_contiguous()
               and x.device == dev, "plan order/offsets and the row order "
               f"must be contiguous int64 on {dev}")
    _check(plan.offsets.shape[0] == n_seg + 1, f"{plan.offsets.shape[0]} "
           f"offsets for {n_seg} segments")
    _check(g * nnz < INDEX_LIMIT and n_seg < INDEX_LIMIT,
           f"{g * nnz} entries, {n_seg} rows: the kernel numbers them in "
           "32 bits")
    n_live = rows.rows.shape[0]
    n_long = rows.n_at_least(long_row(plan.order.shape[0]))
    if not (n_live and f):
        return out
    if heads:
        _check(h in _build.HEADS,
               f"{h} heads: the kernel is built for {_build.HEADS}")
        lib, fn = _heads_kernel()
        extra = (h,)
    else:
        lib, fn = _kernel(vals.dtype, b_tiles.dtype)
        extra = ()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cols.data_ptr(), vals.data_ptr(), b_tiles.data_ptr(),
                 plan.order.data_ptr(), plan.offsets.data_ptr(),
                 rows.rows.data_ptr(), out.data_ptr(), n_long, n_live,
                 n_seg // g, nct * t, f, *extra, stream)
    _build.check(lib, err, "coo_rows launch")
    f32 = instance_dtypes(vals.dtype, b_tiles.dtype) == ("float32",) * 2
    with _build.count_lock:
        launches["float32" if f32 else "bfloat16"] += 1
    return out
