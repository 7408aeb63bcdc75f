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
  * ``ell_spmm_rows`` — one layer's fixed-K buckets (of
    ``repro_torch.core.formats.ell_buckets``) as the "fused"/"loop"
    dispatches run them: the TPU kernel ``_ell_kernel``'s products of
    every bucket, summed onto output rows in the order of the ELL
    ``SegmentPlan`` and added onto the dense engine's rows, in place, by
    one launch of ``csrc/ell_spmm.cu`` for a whole group and every
    bucket;
  * ``ell_spmm`` — the TPU kernel's own function, per-unit products of
    one bucket: the same kernel with every unit row its own row and
    nothing to add onto.

Both CUDA sources share their row loop (``csrc/ell_rows.cuh``). On CPU
tensors each function runs its plain version in
``repro_torch.kernels.ref``.

K bands, as the TPU kernel runs them: the ragged functions take the
reference's ``segments`` (the partition's descending (K, n_units) runs)
and ``max_bands`` (any count from 1), merge the runs to at most
``max_bands`` bands (``kernels.bands``, the port's copy of ``_bands_of``
and ``_band_tables``) and run each unit only to its band's K, with the
values masked by ``unit_k`` inside it; ``segments=()`` is one Kmax band.
The kernel takes up to ``VALUE_BANDS`` (4) bands by value and a plan of
more as a [U] int32 table of each unit's band K (``band_table``, built
once per plan and device and kept on the card); both give the same
bits.
The fixed-K row kernel runs each unit to its bucket's K
(``ReductionPlan.ell_bucket_k``), unmasked. With finite B all of them
give the bits of the masked Kmax pass; with a non-finite B row at a lane
past a unit's band (or bucket) K they differ from it, as the reference's
kernels do.

Types, as the reference's kernels take them: ``vals`` and B each float32
or bfloat16, upcast to float32 before they multiply; products, sums and
the output rows are float32. On the card a bfloat16 operand is widened
where the kernel loads it, so each bfloat16 instance gives, bit for bit,
the float32 instance's result on ``vals.float()`` and ``b.float()``. The
float32 instances are built from ``csrc/ragged_ell_spmm.cu``, the ragged
ones of each pair with a bfloat16 operand from
``csrc/ragged_ell_spmm_<vals>_<B>.cu`` (``ragged_source``; the four
compile in parallel), the fixed-K ones all from ``csrc/ell_spmm.cu``.

The ragged kernel's tunables (``tune``: the launch shape, lanes per
row ``w``, floats per lane ``vec``, K lanes in flight ``kc``,
``threads`` per block, and the band cap ``max_bands``) are swept by
``repro_torch.kernels.autotune``; every value gives the same bits on
finite B. ``ragged_ell_contract`` and ``ell_contract`` return the
launch contracts the wrappers launch from (grid, threads, shape knobs,
alignment, shared memory, the band table, the extents numbered in 32
bits, the index bounds the kernels trust), which ``repro_torch.analysis
.static.kernel_pass`` audits.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.core.formats import SegmentPlan, bucket_runs
from repro_torch.device import resolve_device

from . import _build
from .bands import (DEFAULT_MAX_BANDS, VALUE_BANDS, _band_tables,  # noqa: F401
                    _bands_of, band_mode, check_max_bands, merge_bands,
                    unit_bounds)
from .ref import (ell_spmm_ref, ell_spmm_rows_ref, ragged_ell_rows_ref,
                  ragged_ell_spmm_ref)

# The ragged kernel's launch shape: one instance of each of its kernels per
# combination (csrc/ragged_ell_spmm.cu); the fixed-K kernel runs the
# defaults. Its tunables add the K-band cap, as the reference's do.
LAUNCH_KEYS = ("w", "vec", "kc", "threads")
TUNE_KEYS = LAUNCH_KEYS + ("max_bands",)
TUNE_W = (8, 16, 32)            # lanes per row
TUNE_VEC = (1, 4)               # floats per lane
TUNE_KC = (2, 4, 8)             # K lanes whose B rows are in flight
TUNE_THREADS = (128, 256, 512)  # threads per block
DEFAULT_KC = 4
DEFAULT_THREADS = 256
INDEX_LIMIT = 2 ** 31           # what the kernels number in 32 bits

# Launches of the CUDA kernels since the last reset
# (ops.reset_launch_counts): ``launches`` counts the ragged kernel
# (ragged_ell_rows and ragged_ell_spmm), ``table_launches`` those of its
# launches that read the band table (more than VALUE_BANDS bands),
# ``fixed_k_launches`` the fixed-K kernel (ell_spmm_rows and ell_spmm),
# each split into float32 instances and bfloat16 ones (vals, B or both
# bfloat16).
launches = {"float32": 0, "bfloat16": 0}
table_launches = {"float32": 0, "bfloat16": 0}
fixed_k_launches = {"float32": 0, "bfloat16": 0}

_fns: dict = {}
# (band plan, device) -> the [U] int32 band table on the card (band_table)
_tables: dict = {}
_tables_lock = threading.Lock()


def default_lanes(f: int) -> int:
    """Lanes per row by F, the kernels' default: a narrow row does not
    leave most of a warp idle."""
    return 8 if f <= 8 else 16 if f <= 16 else 32


def resolve_tune(f: int, tune: dict = None, *, aligned: bool = True
                 ) -> dict:
    """The tunables a ``tune`` dict gives at feature width ``f``: the
    launch shape and ``max_bands``, each missing (or None) one at its
    default; ``aligned``: B and the output are 16-byte aligned. A knob
    that is illegal at this F is clamped to its nearest legal value:
    ``vec`` 4 becomes 1 where ``f % 4 != 0`` or a pointer is unaligned.
    Values outside the instance set, and a ``max_bands`` below 1, pass
    through, for the contract audit to reject."""
    tune = dict(tune or {})
    unknown = set(tune) - set(TUNE_KEYS)
    if unknown:
        raise ValueError(f"unknown ragged-kernel knob(s) {sorted(unknown)}; "
                         f"choose from {TUNE_KEYS}")
    vec_ok = f % 4 == 0 and aligned
    w = int(tune.get("w") or default_lanes(f))
    vec = int(tune.get("vec") or (4 if w == 32 and vec_ok else 1))
    if vec == 4 and not vec_ok:
        vec = 1
    mb = tune.get("max_bands")
    return {"w": w, "vec": vec, "kc": int(tune.get("kc") or DEFAULT_KC),
            "threads": int(tune.get("threads") or DEFAULT_THREADS),
            "max_bands": DEFAULT_MAX_BANDS if mb is None else int(mb)}


def band_cap(max_bands: int = None, tune: dict = None) -> int:
    """The K-band cap a ragged launch runs at: ``max_bands``, else
    ``tune``'s, else ``DEFAULT_MAX_BANDS``. ValueError below 1, or where
    both are given and differ."""
    tuned = (tune or {}).get("max_bands")
    if max_bands is None:
        max_bands = DEFAULT_MAX_BANDS if tuned is None else tuned
    elif tuned is not None and int(tuned) != int(max_bands):
        raise ValueError(f"max_bands={max_bands} but tune has max_bands="
                         f"{tuned}")
    return check_max_bands(max_bands)


def instance_dtypes(vals_dtype, b_dtype) -> tuple:
    """The (vals, B) type names of an ELL kernel instance; ValueError for
    a type the kernels do not take."""
    return _build.dtype_name(vals_dtype), _build.dtype_name(b_dtype)


_SHORT = {"float32": "f32", "bfloat16": "bf16"}


def type_suffix(dtypes: tuple) -> str:
    """The suffix of both ELL kernels' C entries (and of the ragged
    kernel's sources) for the (vals, B) type names ``dtypes``: "f32"
    where both are float32, else "<vals>_<B>" ("f32_bf16", ...)."""
    if dtypes == ("float32", "float32"):
        return "f32"
    return "_".join(_SHORT[d] for d in dtypes)


def ragged_source(dtypes: tuple) -> tuple:
    """(source, C entry) of the ragged kernel's instances for the (vals,
    B) type names ``dtypes``: the float32 instances are in
    ``ragged_ell_spmm.cu``, each other pair in a source of its own."""
    suffix = type_suffix(dtypes)
    source = "ragged_ell_spmm" + ("" if suffix == "f32" else "_" + suffix)
    return source, f"ragged_ell_rows_{suffix}"


def _rows_contract(name, kernel, knobs, instance, g, n_slots, shapes, f,
                   aligned, extents, bounds, dtypes, bands) -> dict:
    per_block = max(knobs["threads"] // knobs["w"], 1)
    source = ("ell_spmm" if kernel == "ell_band_kernel"
              else ragged_source(dtypes)[0])
    band_ks, band_counts, band_offs = _band_tables(bands)
    return dict(
        name=name, source=source, kernel=kernel,
        **{k: knobs[k] for k in LAUNCH_KEYS},
        instance=instance + dtypes, dtypes=dtypes,
        ptxas_name=kernel + _build.mangled_args(instance + dtypes),
        grid=(max(-(-n_slots // per_block), 1), g, 1), f=f,
        aligned16=aligned, dyn_smem=0, static_smem=0, smem_optin=False,
        shapes=shapes, bands=tuple(bands), band_ks=band_ks,
        band_counts=band_counts, band_offs=band_offs, extents=extents,
        index_bounds=bounds)


def ragged_ell_contract(g: int, u: int, r: int, kmax: int, nct: int, t: int,
                        f: int, *, segments: tuple = (),
                        max_bands: int = None, tune: dict = None,
                        n_slots: int = None, aligned: bool = True,
                        vals_dtype=torch.float32,
                        b_dtype=torch.float32) -> dict:
    """The launch contract of one ``ragged_ell_rows`` launch, for the
    contract audit and the autotuner (its launch shape is the wrapper's:
    both come from ``resolve_tune``): grid (x, y = G, 1), ``threads``, ``w``,
    ``vec``, ``kc``, the ``instance`` (w, vec, kc, threads), F,
    ``aligned16`` (B aligned to 4 of its elements and the output to 16
    bytes; ``vec`` 4 needs it), shared memory (none), the operand
    ``shapes``, the band table (``bands`` ((K, n_units), ...) from
    ``segments`` and ``max_bands`` as the reference's ``_bands_of`` merges
    them, and its ``band_ks``, ``band_counts``, ``band_offs``), how the
    kernel takes it (``band_mode`` "value", the ``ell_rows_kernel``, or
    "table" past ``VALUE_BANDS`` bands, the ``ell_rows_table_kernel``
    reading the [U] ``band_k`` table of ``shapes``), the ``extents`` the
    kernel numbers in 32 bits, and ``index_bounds`` {operand: exclusive
    bound of its values}. ``n_slots`` is the grid's rows per member: the
    plan's live rows, at most (and by default) every unit row ``u*r``.
    ``tune`` is clamped at this F (``resolve_tune``); its ``max_bands``
    is recorded as given (one below 1 merges as 1, for the audit to
    reject), while a ``max_bands`` argument below 1 raises as the
    wrappers do. ``vals_dtype``/``b_dtype`` pick the instance
    (``instance`` ends with their names, ``dtypes``) and its source."""
    knobs = resolve_tune(f, tune, aligned=aligned)
    if max_bands is not None:
        knobs["max_bands"] = band_cap(max_bands, tune)
    bands = _bands_of(segments, u, kmax, max(knobs["max_bands"], 1))
    mode = band_mode(bands)
    shapes = {"cols": (g, u, r, kmax), "vals": (g, u, r, kmax),
              "tile_col": (g, u), "unit_k": (g, u), "b_tiles": (g, nct, t, f)}
    if mode == "table":
        shapes["band_k"] = (u,)
    n_slots = u * r if n_slots is None else n_slots
    return dict(_rows_contract(
        "ragged_ell_rows",
        "ell_rows_kernel" if mode == "value" else "ell_rows_table_kernel",
        knobs, tuple(knobs[k] for k in LAUNCH_KEYS), g, n_slots, shapes,
        f, aligned, {"unit rows": g * u * r, "plan entries": g * u * r,
                     "grid rows": g * n_slots},
        {"tile_col": nct, "cols": t, "unit_k": kmax + 1},
        instance_dtypes(vals_dtype, b_dtype), bands),
        max_bands=knobs["max_bands"], band_mode=mode)


def ell_contract(g: int, u: int, r: int, kmax: int, nct: int, t: int, f: int,
                 *, segments: tuple = (), n_slots: int = None,
                 aligned: bool = True, vals_dtype=torch.float32,
                 b_dtype=torch.float32) -> dict:
    """The launch contract of one fixed-K ``ell_spmm_rows`` launch over a
    layer's slab [G, U, R, Kmax] (the ragged contract's keys; the kernel
    runs the default launch shape, no knob). Its band table is the
    buckets (``formats.bucket_runs`` of ``segments``), each unit read to
    its bucket's K (``bucket_k``). ``n_slots``: the plan's live rows per
    member, at most (and by default) ``u*r``; the types as for
    ``ragged_ell_contract``."""
    knobs = resolve_tune(f, aligned=aligned)
    n_slots = u * r if n_slots is None else n_slots
    return _rows_contract(
        "ell_spmm_rows", "ell_band_kernel", knobs,
        (knobs["w"], knobs["vec"]), g, n_slots,
        {"cols": (g, u, r, kmax), "vals": (g, u, r, kmax),
         "tile_col": (g, u), "bucket_k": (u,), "b_tiles": (g, nct, t, f)},
        f, aligned, {"unit rows": g * u * r, "plan entries": g * u * r,
                     "grid rows": g * n_slots},
        {"tile_col": nct, "cols": t, "bucket_k": kmax + 1},
        instance_dtypes(vals_dtype, b_dtype), bucket_runs(u, kmax, segments))


def contract_cost(c: dict, *, cols=None, tile_col=None, plan=None) -> dict:
    """HBM bytes and FMA FLOPs of one launch of ``c`` (a
    ``ragged_ell_contract`` or an ``ell_contract``): what the CUDA kernel
    reads and writes once each, and the operations it executes (the
    counterpart of the reference's ``contract_cost``, which counts the
    TPU's blocks; here there are none, each grid row gathers what its
    sums address).

    Each unit's chain reads the lanes below its band's K (ragged) or its
    bucket's K (fixed K), ``c["bands"]``; the lanes past it are not read.
    A ragged launch of more than ``VALUE_BANDS`` bands (``band_mode``
    "table") also reads its band table, 4 bytes a distinct unit index.
    Given the launch's data (``cols``, ``tile_col`` and ``plan``, the ELL
    ``SegmentPlan``; read on the host), it counts what this launch's plan
    sums: for each unit row in the plan, cols and vals of the lanes its
    chain reads (the ragged kernel masks the values, not the loads, so a
    masked lane inside the band is read too) and its 8-byte order entry;
    tile_col and unit_k (ragged) or bucket_k (fixed K) of each unit the
    plan reaches; the plan's offsets of the live rows and their live-table
    entries; each distinct B row [F] those lanes address; each live output
    row read and written. Operations: a multiply and an add per lane read
    and feature, one add per unit row and feature onto its row's sum, and
    one add per live row and feature onto the dense engine's rows. vals
    and B count the bytes of their types (the contract's ``dtypes``);
    indices and the output rows are 4-byte int32 / float32.

    Without data, the most the shapes allow: every unit row summed,
    every grid row live, every B row read."""
    g, u, r, kmax = c["shapes"]["cols"]
    _, nct, t, f = c["shapes"]["b_tiles"]
    n_slots = c["extents"]["grid rows"] // g
    bound = unit_bounds(c["bands"]).astype(np.int64)       # [U] lanes read
    table = c.get("band_mode") == "table"
    if plan is None:
        e, units, live = g * u * r, g * u, g * n_slots
        lanes = g * r * int(bound.sum())
        b_rows, out_rows = min(g * nct * t, lanes), live
        index = (2 * live + 1) * 8
        table_units = u
    else:
        cv = cols.cpu().numpy().reshape(-1, kmax)
        tc = tile_col.cpu().numpy().reshape(-1)
        order = plan.order.cpu().numpy()
        segs = np.flatnonzero(plan.lengths.cpu().numpy())
        unit = order // r                              # over the group
        kb = bound[unit % u]
        read = np.arange(kmax)[None, :] < kb[:, None]
        e, units, live = order.size, np.unique(unit).size, segs.size
        lanes = int(kb.sum())
        b_rows = np.unique((((unit // u) * nct + tc[unit])[:, None] * t
                            + cv[order])[read]).size
        out_rows = live
        index = (np.unique(np.concatenate([segs, segs + 1])).size
                 + live) * 8
        table_units = np.unique(unit % u).size
    vb, bb = (torch.empty((), dtype=getattr(torch, d)).element_size()
              for d in c["dtypes"])
    nbytes = (lanes * (4 + vb) + units * 8 + e * 8 + index
              + b_rows * f * bb + out_rows * f * 8
              + (table_units * 4 if table else 0))
    flops = 2.0 * lanes * f + e * f + out_rows * f
    return {"hbm_bytes": float(nbytes), "flops": float(flops)}


def _aligned(b: torch.Tensor, *outs) -> bool:
    """``vec`` 4 may run: B aligned to 4 of its elements, each float32
    output to 16 bytes."""
    return (b.data_ptr() % (4 * b.element_size()) == 0
            and all(x.data_ptr() % 16 == 0 for x in outs))


def _entry(source: str, entry: str, argtypes: list):
    """(library, C entry) ``entry`` of ``csrc/<source>.cu``, loaded once."""
    if entry not in _fns:
        lib = _build.library(source)
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[entry] = (lib, fn)
    return _fns[entry]


def _kernel(vals_dtype, b_dtype):
    """The ragged kernel's C entry for these types."""
    return _entry(*ragged_source(instance_dtypes(vals_dtype, b_dtype)),
                  [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12
                  + [ctypes.c_void_p])


def band_args(bands) -> ctypes.Array:
    """A band plan of at most ``VALUE_BANDS`` bands as the ragged kernel
    takes it by value (``ell_rows::Bands``): seven ints, the bands' Ks (0
    past the last), then the first unit of each band past the first
    (INT_MAX past the last)."""
    ks, _, offs = _band_tables(bands)
    ks = list(ks) + [0] * (VALUE_BANDS - len(ks))
    offs = list(offs) + [INDEX_LIMIT - 1] * (VALUE_BANDS - 1 - len(offs))
    return (ctypes.c_int * 7)(*ks, *offs)


def band_table(bands, device) -> torch.Tensor:
    """The band plan ``bands`` as the ragged kernel reads a plan of more
    than ``VALUE_BANDS`` bands: [U] int32, each unit's band K
    (``unit_bounds``), on ``device``. Built once per (plan, device), one
    fill a band on the device (no copy from the host) and one wait for
    the stream, then kept: every later launch reads the kept table, with
    no copy and no wait. It cannot be built while the stream is captured
    into a CUDA graph (the fills would only be recorded), so a first
    launch inside a capture raises; one launch before the capture builds
    it, as a graph's warm-up call does."""
    dev = resolve_device(device)
    key = (tuple(bands), str(dev))
    table = _tables.get(key)
    if table is not None:
        return table
    with _tables_lock:
        table = _tables.get(key)
        if table is None:
            cuda = dev.type == "cuda"
            if cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"band_table: the table of {len(bands)} bands is not "
                    "built yet and the stream is being captured; launch "
                    "once before the capture")
            table = torch.empty(sum(n for _, n in bands), dtype=torch.int32,
                                device=dev)
            at = 0
            for k, n in bands:
                table[at:at + n].fill_(k)
                at += n
            if cuda:
                torch.cuda.current_stream(dev).synchronize()
            _tables[key] = table
    return table


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
           and unit_k.dtype == torch.int32
           and vals.dtype in _build.DTYPES and b_tiles.dtype in _build.DTYPES,
           "expected int32 cols/tile_col/unit_k and float32 or bfloat16 "
           f"vals/B (got {vals.dtype}, {b_tiles.dtype})", what)
    for x in (cols, vals, tile_col, unit_k, b_tiles):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}", what)
        _check(dev.type == "cpu" or x.is_contiguous(),
               "CUDA kernel needs contiguous tensors", what)
    _check(dev.type == "cpu" or g * u * r < 2 ** 31,
           f"{g * u * r} unit rows: the kernel numbers them in 32 bits",
           what)
    return cols, vals, tile_col, unit_k, b_tiles, grouped


def _launch(cols, vals, tile_col, unit_k, b_tiles, plan, out, n_slots,
            dev, tune, bands) -> None:
    """One kernel launch; ``plan`` None = unit mode."""
    g, u, r, kmax = cols.shape
    _, nct, t, f = b_tiles.shape
    if not (g and n_slots and f):
        return
    knobs = resolve_tune(f, tune, aligned=_aligned(b_tiles, out))
    lib, fn = _kernel(vals.dtype, b_tiles.dtype)
    f32 = instance_dtypes(vals.dtype, b_tiles.dtype) == ("float32",) * 2
    idx = ((None,) * 3 if plan is None else
           (plan.order.data_ptr(), plan.offsets.data_ptr(),
            plan.live.data_ptr()))
    table = band_table(bands, dev) if band_mode(bands) == "table" else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cols.data_ptr(), vals.data_ptr(), tile_col.data_ptr(),
                 unit_k.data_ptr(), b_tiles.data_ptr(), *idx, out.data_ptr(),
                 band_args(() if table is not None else bands),
                 None if table is None else table.data_ptr(),
                 g, n_slots, u, r, kmax, nct, t, f,
                 *(knobs[k] for k in LAUNCH_KEYS), stream)
    _build.check(lib, err, "ragged_ell_spmm launch")
    with _build.count_lock:
        launches["float32" if f32 else "bfloat16"] += 1
        if table is not None:
            table_launches["float32" if f32 else "bfloat16"] += 1


def ragged_ell_rows(cols: torch.Tensor, vals: torch.Tensor,
                    tile_col: torch.Tensor, unit_k: torch.Tensor,
                    b_tiles: torch.Tensor, plan: SegmentPlan,
                    out: torch.Tensor, *, segments: tuple = (),
                    max_bands: int = None, tune: dict = None,
                    device="cuda") -> torch.Tensor:
    """The sparse engine's rows, added onto ``out`` in place.

    cols/vals [G, U, R, Kmax] (int32 tile-local / f32 or bf16),
    tile_col/unit_k [G, U] int32, b_tiles [G, nct, T, F] f32 or bf16,
    ``plan`` the ELL
    ``SegmentPlan`` (entries ``g*U*R + u*R + r`` onto segments
    ``g*P + row``, the sentinel dropped, with its ``live`` table) and
    ``out`` [G, P, F] f32, which holds the dense engine's rows. Each row
    with ELL entries becomes ``out[row] + sum of its unit rows' products``
    (the sum in plan order, from +0); rows without one are not touched.
    Returns ``out``.

    ``segments`` (the partition's descending (K, n_units) runs,
    ``meta.ell_segments``) and ``max_bands`` (any count from 1; None:
    ``tune``'s, else ``DEFAULT_MAX_BANDS``, ``band_cap``) give the K
    bands, as the reference's kernel takes them: each unit's product runs
    to its band's K, the values masked by ``unit_k`` inside it;
    ``segments=()`` is one Kmax band. Past ``VALUE_BANDS`` bands the
    kernel reads each unit's band K from the kept ``band_table``.
    ``tune`` is the kernel's tunables (``resolve_tune``; None = the
    defaults); at finite B every value gives the same bits.

    Every tensor must lie on ``device``. CPU tensors take the plain
    version (``ragged_ell_spmm_ref``, ``segment_sum``, then the add);
    CUDA tensors launch the kernel or raise.
    """
    what = "ragged_ell_rows"
    _build.tick(what)
    dev = resolve_device(device)
    cols, vals, tile_col, unit_k, b_tiles, _ = _checked(
        cols, vals, tile_col, unit_k, b_tiles, dev, what)
    g, u, r, kmax = cols.shape
    f = b_tiles.shape[-1]
    resolve_tune(f, tune)          # unknown knobs raise on every device
    max_bands = band_cap(max_bands, tune)
    bands = _bands_of(segments, u, kmax, max_bands)
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
                                   plan, out, segments=segments,
                                   max_bands=max_bands)
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
            plan.live.shape[1], dev, tune, bands)
    return out


HEADS_KERNELS = ("ell_rows_heads_kernel", "ell_rows_heads_table_kernel")


def ragged_ell_heads_contract(g: int, u: int, r: int, kmax: int, nct: int,
                              t: int, f: int, h: int, *,
                              segments: tuple = (), n_slots: int = None,
                              aligned: bool = True) -> dict:
    """The launch contract of one ``ragged_ell_rows_heads`` launch with
    ``h`` values an entry: ``ragged_ell_contract``'s keys at the
    multi-head instance's launch shape (the defaults, ``vec`` 4 only where
    a head's F / H features are whole vectors), its
    kernel (``ell_rows_heads_kernel``, or ``ell_rows_heads_table_kernel``
    past ``VALUE_BANDS`` bands), the instance (w, vec, h) and vals
    [G, U, R, Kmax, H]."""
    c = ragged_ell_contract(g, u, r, kmax, nct, t, f, segments=segments,
                            n_slots=n_slots,
                            aligned=aligned and (f // h) % 4 == 0)
    kernel = HEADS_KERNELS[c["band_mode"] == "table"]
    instance = (c["w"], c["vec"], h)
    c.update(name="ragged_ell_rows_heads", kernel=kernel, instance=instance,
             dtypes=("float32", "float32"),
             ptxas_name=kernel + _build.mangled_args(instance))
    c["shapes"] = dict(c["shapes"], vals=(g, u, r, kmax, h))
    c["extents"] = dict(c["extents"], **{"value lanes": g * u * r * kmax * h})
    return c


def ragged_ell_rows_heads(cols: torch.Tensor, vals: torch.Tensor,
                          tile_col: torch.Tensor, unit_k: torch.Tensor,
                          b_tiles: torch.Tensor, plan: SegmentPlan,
                          out: torch.Tensor, *, segments: tuple = (),
                          max_bands: int = None,
                          device="cuda") -> torch.Tensor:
    """``ragged_ell_rows`` with H values an entry: vals [G, U, R, Kmax, H]
    f32, feature f of B (f32, F a multiple of H) multiplied by the value
    of its head f / (F / H); the launch shape the defaults (``vec`` 4
    where a head's F / H features are whole vectors), the K bands as
    there. Returns ``out``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (H in ``_build.HEADS``), one launch for the group, or raise."""
    what = "ragged_ell_rows_heads"
    _build.tick(what)
    dev = resolve_device(device)
    _check(vals.dim() == 5, f"expected vals [G,U,R,Kmax,H], got "
           f"{tuple(vals.shape)}", what)
    h = vals.shape[-1]
    _check(cols.dim() == 4 and b_tiles.dim() == 4
           and tuple(vals.shape[:4]) == tuple(cols.shape)
           and tuple(tile_col.shape) == tuple(unit_k.shape)
           == tuple(cols.shape[:2]) and b_tiles.shape[0] == cols.shape[0],
           f"shapes differ: cols {tuple(cols.shape)}, vals "
           f"{tuple(vals.shape)}, tile_col {tuple(tile_col.shape)}, unit_k "
           f"{tuple(unit_k.shape)}, b_tiles {tuple(b_tiles.shape)}", what)
    _check(cols.dtype == tile_col.dtype == unit_k.dtype == torch.int32,
           "expected int32 cols/tile_col/unit_k", what)
    for x in (cols, vals, tile_col, unit_k, b_tiles):
        _check(x.device == dev, f"tensor on {x.device}, device={dev}", what)
        _check(dev.type == "cpu" or x.is_contiguous(),
               "CUDA kernel needs contiguous tensors", what)
    g, u, r, kmax = cols.shape
    f = b_tiles.shape[-1]
    _check(vals.dtype == torch.float32 and b_tiles.dtype == torch.float32
           and f % h == 0, f"float32 vals and B, {f} columns over {h} heads",
           what)
    bands = _bands_of(segments, u, kmax, band_cap(max_bands))
    n_seg = plan.lengths.shape[0]
    _check(out.dim() == 3 and tuple(out.shape) == (g, n_seg // g, f)
           and out.dtype == torch.float32 and out.device == dev,
           f"out {tuple(out.shape)} {out.dtype}: want float32 "
           f"[{g}, {n_seg // g}, {f}] on {dev}", what)
    if dev.type == "cpu":
        return ragged_ell_rows_ref(cols, vals, tile_col, unit_k, b_tiles,
                                   plan, out, segments=segments,
                                   max_bands=band_cap(max_bands))
    _check(h in _build.HEADS,
           f"{h} heads: the kernel is built for {_build.HEADS}", what)
    _check(vals.is_contiguous() and out.is_contiguous(),
           "CUDA kernel needs contiguous tensors", what)
    _check(g * u * r * kmax * h < INDEX_LIMIT, "the kernel numbers "
           "value lanes in 32 bits", what)
    n_slots = plan.live.shape[1]
    if not (g and n_slots and f):
        return out
    lib, fn = _entry("ragged_ell_spmm", "ragged_ell_rows_heads_f32",
                     [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                     + [ctypes.c_void_p])
    table = band_table(bands, dev) if band_mode(bands) == "table" else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cols.data_ptr(), vals.data_ptr(), tile_col.data_ptr(),
                 unit_k.data_ptr(), b_tiles.data_ptr(), plan.order.data_ptr(),
                 plan.offsets.data_ptr(), plan.live.data_ptr(),
                 out.data_ptr(), band_args(() if table is not None else bands),
                 None if table is None else table.data_ptr(),
                 g, n_slots, u, r, kmax, b_tiles.shape[1], b_tiles.shape[2],
                 f, h, stream)
    _build.check(lib, err, "ragged_ell_spmm heads launch")
    with _build.count_lock:
        launches["float32"] += 1
        if table is not None:
            table_launches["float32"] += 1
    return out


def ragged_ell_spmm(cols: torch.Tensor, vals: torch.Tensor,
                    tile_col: torch.Tensor, unit_k: torch.Tensor,
                    b_tiles: torch.Tensor, *, segments: tuple = (),
                    max_bands: int = None, tune: dict = None,
                    device="cuda") -> torch.Tensor:
    """Per-unit ELL products over the concatenated ragged unit array.

    cols [(G,) U, R, Kmax] int32 (tile-local), vals [(G,) U, R, Kmax] f32
    or bf16, tile_col [(G,) U] int32, unit_k [(G,) U] int32, b_tiles
    [(G,) nct, T, F] f32 or bf16  ->  [(G,) U, R, F] f32. ONE launch
    covers every K width, each unit to its band's K (``segments``,
    ``max_bands`` and ``tune`` as for ``ragged_ell_rows``). Every tensor
    must lie on ``device``; CPU tensors take the plain version, CUDA
    tensors launch the kernel or raise. Indices must be in range
    (``cols < T``, ``tile_col < nct``): partitions guarantee it and
    ``Engine.register`` checks it on the host.
    """
    _build.tick("ragged_ell_spmm")
    dev = resolve_device(device)
    cols, vals, tile_col, unit_k, b_tiles, grouped = _checked(
        cols, vals, tile_col, unit_k, b_tiles, dev, "ragged_ell_spmm")
    resolve_tune(b_tiles.shape[-1], tune)
    g, u, r, kmax = cols.shape
    max_bands = band_cap(max_bands, tune)
    bands = _bands_of(segments, u, kmax, max_bands)
    if dev.type == "cpu":
        out = ragged_ell_spmm_ref(cols, vals, tile_col, unit_k, b_tiles,
                                  segments=segments, max_bands=max_bands)
        return out if grouped else out[0]
    out = torch.empty((g, u, r, b_tiles.shape[-1]), dtype=torch.float32,
                      device=dev)
    _launch(cols, vals, tile_col, unit_k, b_tiles, None, out, u * r, dev,
            tune, bands)
    return out if grouped else out[0]


def _fixed_kernel(vals_dtype, b_dtype):
    """The fixed-K kernel's C entry for these types."""
    suffix = type_suffix(instance_dtypes(vals_dtype, b_dtype))
    return _entry("ell_spmm", f"ell_spmm_rows_{suffix}",
                  [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                  + [ctypes.c_longlong, ctypes.c_int]
                  + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])


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
           and vals.dtype in _build.DTYPES and b_tiles.dtype in _build.DTYPES,
           "expected int32 cols/tile_col and float32 or bfloat16 vals/B "
           f"(got {vals.dtype}, {b_tiles.dtype})", what)
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


def _fixed_launch(cols, vals, tile_col, b_tiles, bucket_k, plan, out,
                  n_slots, out_sg, dev) -> None:
    """One launch of the fixed-K kernel; ``plan`` None = unit mode."""
    g, u, r, k = cols.shape
    _, nct, t, f = b_tiles.shape
    if not (g and n_slots and f):
        return
    lib, fn = _fixed_kernel(vals.dtype, b_tiles.dtype)
    f32 = instance_dtypes(vals.dtype, b_tiles.dtype) == ("float32",) * 2
    idx = ((None,) * 4 if plan is None else
           (bucket_k.data_ptr(), plan.order.data_ptr(),
            plan.offsets.data_ptr(), plan.live.data_ptr()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cols.data_ptr(), vals.data_ptr(), tile_col.data_ptr(),
                 idx[0], b_tiles.data_ptr(), *idx[1:], out.data_ptr(),
                 g, n_slots, u, r, k, nct, t, f, cols.stride(0),
                 _row_stride(cols), tile_col.stride(0), out_sg, stream)
    _build.check(lib, err, "ell_spmm launch")
    with _build.count_lock:
        fixed_k_launches["float32" if f32 else "bfloat16"] += 1


def ell_spmm_rows(cols: torch.Tensor, vals: torch.Tensor,
                  tile_col: torch.Tensor, b_tiles: torch.Tensor,
                  plan: SegmentPlan, out: torch.Tensor,
                  bucket_k: torch.Tensor, *, device="cuda") -> torch.Tensor:
    """One layer's fixed-K ELL rows, every bucket in one launch, added
    onto ``out`` in place.

    cols/vals [G, U, R, Kmax] (int32 tile-local / f32 or bf16: the ragged
    slab), tile_col [G, U] int32, b_tiles [G, nct, T, F] f32 or bf16,
    ``plan`` the ELL ``SegmentPlan`` (as for ``ragged_ell_rows``, with
    its ``live`` table), ``out`` [G, P, F] f32, which holds the dense
    engine's rows, and ``bucket_k`` [U] int32, the K of each unit's
    bucket of ``meta.ell_segments`` (``ReductionPlan.ell_bucket_k``). Each
    unit row's product is its bucket's fixed-K chain (the bucket's K lanes
    read in place, no value mask); each row with ELL entries becomes
    ``out[row] + sum of its unit rows' products`` (the sum in plan order,
    from +0, which is the buckets in order, each in unit order); rows
    without one are not touched. This is ``out + scatter_ell_partials`` of
    the per-bucket products on "fused" and on "loop", bit for bit.
    Returns ``out``.

    Every tensor must lie on ``device``. CPU tensors take the plain
    version (``ell_spmm_rows_ref``); CUDA tensors launch the kernel (one
    launch for the group and every bucket) or raise.
    """
    what = "ell_spmm_rows"
    _build.tick(what)
    dev = resolve_device(device)
    cols, vals, tile_col, b_tiles, _ = _fixed_checked(
        cols, vals, tile_col, b_tiles, dev, what)
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
    _check(bucket_k is not None and tuple(bucket_k.shape) == (u,)
           and bucket_k.dtype == torch.int32 and bucket_k.device == dev,
           f"bucket_k must be int32 [{u}] on {dev} (the plan's "
           "ell_bucket_k)", what)
    if dev.type == "cpu":
        return ell_spmm_rows_ref(cols, vals, tile_col, b_tiles, plan, out,
                                 bucket_k)
    _check(cols.is_contiguous() and vals.is_contiguous()
           and tile_col.is_contiguous() and bucket_k.is_contiguous(),
           "CUDA kernel needs the contiguous ragged slab and bucket_k",
           what)
    _check(plan.live.dim() == 2 and plan.live.shape[0] == g,
           f"plan needs its live table [{g}, L] (segment_live)", what)
    for x in (plan.order, plan.offsets, plan.live):
        _check(x.dtype == torch.int64 and x.is_contiguous()
               and x.device == dev, "plan order/offsets/live must be "
               f"contiguous int64 on {dev}", what)
    _check(plan.offsets.shape[0] == n_seg + 1, f"{plan.offsets.shape[0]} "
           f"offsets for {n_seg} segments", what)
    _check(out.is_contiguous(), "CUDA kernel needs a contiguous out", what)
    _fixed_launch(cols, vals, tile_col, b_tiles, bucket_k, plan, out,
                  plan.live.shape[1], 0, dev)
    return out


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, tile_col: torch.Tensor,
             b_tiles: torch.Tensor, *, out: torch.Tensor = None,
             device="cuda") -> torch.Tensor:
    """Per-unit ELL products of one fixed-K bucket.

    cols [(G,) U, R, K] int32 (tile-local), vals [(G,) U, R, K] f32 or
    bf16, tile_col [(G,) U] int32, b_tiles [(G,) nct, T, F] f32 or bf16
    -> [(G,) U, R, F] f32; one launch for the whole group, of
    ``ell_spmm_rows``'s kernel with every unit row its own row and
    nothing to add onto.
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
    _build.tick(what)
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
    _fixed_launch(cols, vals, tile_col, b_tiles, None, None, out, u * r,
                  out.stride(0), dev)
    return out if grouped else out[0]
