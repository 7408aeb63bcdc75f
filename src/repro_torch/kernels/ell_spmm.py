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

Types, as the reference's kernels take them: ``vals`` and B each float32
or bfloat16, upcast to float32 before they multiply; products, sums and
the output rows are float32. On the card a bfloat16 operand is widened
where the kernel loads it, so each bfloat16 instance gives, bit for bit,
the float32 instance's result on ``vals.float()`` and ``b.float()``. The
float32 instances are built from ``csrc/ragged_ell_spmm.cu``, the ragged
ones of each pair with a bfloat16 operand from
``csrc/ragged_ell_spmm_<vals>_<B>.cu`` (``ragged_source``; the four
compile in parallel), the fixed-K ones all from ``csrc/ell_spmm.cu``.

The ragged kernel's launch shape is a knob (``tune``: lanes per row
``w``, floats per lane ``vec``, K lanes in flight ``kc``, ``threads``
per block), swept by ``repro_torch.kernels.autotune``; every value gives
the same bits. ``ragged_ell_contract`` and ``ell_contract`` return the
launch contracts the wrappers launch from (grid, threads, shape knobs,
alignment, shared memory, the extents numbered in 32 bits, the index
bounds the kernels trust), which ``repro_torch.analysis.static
.kernel_pass`` audits.

The module also keeps its own copy of the reference's K-band helpers
(``merge_bands``, ``_bands_of``, ``_band_tables``, ``DEFAULT_MAX_BANDS``):
the port's shape classes plan their band slots with them. The ragged
kernel loops every unit to Kmax and the band kernel to its band's K, so
band plans change class shapes and the per-K dispatches' launches,
never results.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.formats import BandPlan, SegmentPlan
from repro_torch.device import resolve_device

from . import _build
from .ref import (ell_spmm_ref, ell_spmm_rows_ref, ragged_ell_rows_ref,
                  ragged_ell_spmm_ref)

# Band-merge cap of the class band plans (the reference's value).
DEFAULT_MAX_BANDS = 4

# The ragged kernel's launch knobs: one kernel instance per combination
# (csrc/ragged_ell_spmm.cu); the fixed-K kernel runs the defaults.
TUNE_KEYS = ("w", "vec", "kc", "threads")
TUNE_W = (8, 16, 32)            # lanes per row
TUNE_VEC = (1, 4)               # floats per lane
TUNE_KC = (2, 4, 8)             # K lanes whose B rows are in flight
TUNE_THREADS = (128, 256, 512)  # threads per block
DEFAULT_KC = 4
DEFAULT_THREADS = 256
INDEX_LIMIT = 2 ** 31           # what the kernels number in 32 bits

# Launches of the CUDA kernels since the last reset
# (ops.reset_launch_counts): ``launches`` counts the ragged kernel
# (ragged_ell_rows and ragged_ell_spmm), ``fixed_k_launches`` the fixed-K
# one (ell_spmm_rows and ell_spmm), each split into float32 instances and
# bfloat16 ones (vals, B or both bfloat16).
launches = {"float32": 0, "bfloat16": 0}
fixed_k_launches = {"float32": 0, "bfloat16": 0}

_fns: dict = {}


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


def default_lanes(f: int) -> int:
    """Lanes per row by F, the kernels' default: a narrow row does not
    leave most of a warp idle."""
    return 8 if f <= 8 else 16 if f <= 16 else 32


def resolve_tune(f: int, tune: dict = None, *, aligned: bool = True
                 ) -> dict:
    """The launch shape a ``tune`` dict gives at feature width ``f``,
    each missing (or None) knob at its default; ``aligned``: B and the
    output are 16-byte aligned. A knob that is illegal at this F is
    clamped to its nearest legal value: ``vec`` 4 becomes 1 where
    ``f % 4 != 0`` or a pointer is unaligned. Values outside the
    instance set pass through, for the contract audit to reject."""
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
    return {"w": w, "vec": vec, "kc": int(tune.get("kc") or DEFAULT_KC),
            "threads": int(tune.get("threads") or DEFAULT_THREADS)}


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
                   aligned, extents, bounds, dtypes) -> dict:
    per_block = max(knobs["threads"] // knobs["w"], 1)
    source = ("ell_spmm" if kernel == "ell_band_kernel"
              else ragged_source(dtypes)[0])
    return dict(
        name=name, source=source, kernel=kernel, **knobs,
        instance=instance + dtypes, dtypes=dtypes,
        ptxas_name=kernel + _build.mangled_args(instance + dtypes),
        grid=(max(-(-n_slots // per_block), 1), g, 1), f=f,
        aligned16=aligned, dyn_smem=0, static_smem=0, smem_optin=False,
        shapes=shapes, extents=extents, index_bounds=bounds)


def ragged_ell_contract(g: int, u: int, r: int, kmax: int, nct: int, t: int,
                        f: int, *, tune: dict = None, n_slots: int = None,
                        aligned: bool = True, vals_dtype=torch.float32,
                        b_dtype=torch.float32) -> dict:
    """The launch contract of one ``ragged_ell_rows`` launch, for the
    contract audit and the autotuner (its launch shape is the wrapper's:
    both come from ``resolve_tune``): grid (x, y = G, 1), ``threads``, ``w``,
    ``vec``, ``kc``, the ``instance`` (w, vec, kc, threads), F,
    ``aligned16`` (B aligned to 4 of its elements and the output to 16
    bytes; ``vec`` 4 needs it), shared memory (none), the operand
    ``shapes``, the ``extents`` the kernel numbers in 32 bits, and
    ``index_bounds`` {operand: exclusive bound of its values}. ``n_slots``
    is the grid's rows per member: the plan's live rows, at most (and by
    default) every unit row ``u*r``. ``tune`` is clamped at this F
    (``resolve_tune``). ``vals_dtype``/``b_dtype`` pick the instance
    (``instance`` ends with their names, ``dtypes``) and its source."""
    knobs = resolve_tune(f, tune, aligned=aligned)
    n_slots = u * r if n_slots is None else n_slots
    return _rows_contract(
        "ragged_ell_rows", "ell_rows_kernel", knobs,
        tuple(knobs[k] for k in TUNE_KEYS), g, n_slots,
        {"cols": (g, u, r, kmax), "vals": (g, u, r, kmax),
         "tile_col": (g, u), "unit_k": (g, u), "b_tiles": (g, nct, t, f)},
        f, aligned, {"unit rows": g * u * r, "plan entries": g * u * r,
                     "grid rows": g * n_slots},
        {"tile_col": nct, "cols": t, "unit_k": kmax + 1},
        instance_dtypes(vals_dtype, b_dtype))


def ell_contract(g: int, u: int, r: int, k: int, nct: int, t: int, f: int,
                 *, n_slots: int = None, aligned: bool = True,
                 vals_dtype=torch.float32, b_dtype=torch.float32) -> dict:
    """The launch contract of one fixed-K ``ell_spmm_rows`` launch over a
    band [G, U_b, R, K] (the ragged contract's keys; the kernel runs the
    default launch shape, no knob). ``n_slots``: the band's live rows per
    member, at most (and by default) ``u*r``; the types as for
    ``ragged_ell_contract``."""
    knobs = resolve_tune(f, aligned=aligned)
    n_slots = u * r if n_slots is None else n_slots
    return _rows_contract(
        "ell_spmm_rows", "ell_band_kernel", knobs,
        (knobs["w"], knobs["vec"]), g, n_slots,
        {"cols": (g, u, r, k), "vals": (g, u, r, k), "tile_col": (g, u),
         "b_tiles": (g, nct, t, f)},
        f, aligned, {"unit rows": g * u * r, "grid rows": g * n_slots},
        {"tile_col": nct, "cols": t}, instance_dtypes(vals_dtype, b_dtype))


def contract_cost(c: dict, *, cols=None, tile_col=None, plan=None,
                  seen: dict = None) -> dict:
    """HBM bytes and FMA FLOPs of one launch of ``c`` (a
    ``ragged_ell_contract`` or an ``ell_contract``): what the CUDA kernel
    reads and writes once each, and the operations it executes (the
    counterpart of the reference's ``contract_cost``, which counts the
    TPU's blocks; here there are none, each grid row gathers what its
    sums address).

    Given the launch's data (``cols``, ``tile_col`` and ``plan``: the
    ``SegmentPlan`` of a ragged launch, the band's ``BandPlan`` of a
    fixed-K one; read on the host), it counts what this launch's plan
    sums: for each unit row in the plan, all K lanes of cols and vals
    (the ragged kernel masks the values, not the loads, so a masked
    lane is read too) and its 8-byte order entry; tile_col of each unit
    the plan reaches (and unit_k, ragged); the plan's offsets of the live
    rows, and their live-table entries (ragged) or their row, offset and
    carry entries (fixed K); each distinct B row [F] those lanes address;
    each live output row read and written; the carry buffer's rows a band
    writes or reads. Operations: K multiply-adds per feature per unit
    row, one add per unit row and feature onto its row's sum, and one
    add per live row and feature onto the dense engine's rows. vals and
    B count the bytes of their types (the contract's ``dtypes``); indices,
    the output rows and the carry are 4-byte int32 / float32.

    ``seen`` (fixed K): a dict shared by a layer's band launches; a B row
    or an output row that an earlier launch of the layer counted is not
    counted again, so the launches' costs sum to the layer's (every input
    read once, every output written once). Without it each launch counts
    its own.

    Without data, the most the shapes allow: every unit row summed,
    every grid row live, every B row read."""
    g, u, r, k = c["shapes"]["cols"]
    _, nct, t, f = c["shapes"]["b_tiles"]
    ragged = c["name"] == "ragged_ell_rows"
    n_slots = c["extents"]["grid rows"] // g
    if plan is None:
        e, units, live = g * u * r, g * u, g * n_slots
        b_rows, out_rows = min(g * nct * t, e * k), live
        index = (2 * live + 1 if ragged else 3 * live + 1) * 8
        carried = 0
    elif ragged:
        cv = cols.cpu().numpy().reshape(-1, k)
        tc = tile_col.cpu().numpy().reshape(-1)
        order = plan.order.cpu().numpy()
        segs = np.flatnonzero(plan.lengths.cpu().numpy())
        unit = order // r                              # over the group
        e, units, live = order.size, np.unique(unit).size, segs.size
        b_rows = np.unique(((unit // u) * nct + tc[unit])[:, None] * t
                           + cv[order]).size
        out_rows = live
        index = (np.unique(np.concatenate([segs, segs + 1])).size
                 + live) * 8
        carried = 0
    else:
        rows = plan.rows.cpu().numpy()
        gi, si = np.nonzero(rows >= 0)
        lengths = np.diff(plan.offsets.cpu().numpy()).reshape(rows.shape)
        member = np.repeat(gi, lengths[gi, si])
        order = plan.order.cpu().numpy()
        unit = order // r
        cv = cols.cpu().numpy().reshape(g, u * r, k)[member, order]
        tc = tile_col.cpu().numpy()[member, unit]
        e, live = order.size, gi.size
        units = np.unique(member * u + unit).size
        brs = set(((member * nct + tc)[:, None] * t + cv).reshape(-1)
                  .tolist())
        outs = set((gi * (1 << 32) + rows[gi, si]).tolist())
        if seen is not None:
            brs -= seen.setdefault("b_rows", set())
            outs -= seen.setdefault("out_rows", set())
            seen["b_rows"] |= brs
            seen["out_rows"] |= outs
        b_rows, out_rows = len(brs), len(outs)
        index = (3 * live + 1) * 8
        carried = int((plan.carry.cpu().numpy()[gi, si] >= 0).sum())
    vb, bb = (torch.empty((), dtype=getattr(torch, d)).element_size()
              for d in c["dtypes"])
    nbytes = (e * k * (4 + vb) + units * (8 if ragged else 4) + e * 8 + index
              + b_rows * f * bb + out_rows * f * 8 + carried * f * 4)
    flops = 2.0 * e * k * f + e * f + out_rows * f
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
                  [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                  + [ctypes.c_void_p])


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
            dev, tune) -> None:
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cols.data_ptr(), vals.data_ptr(), tile_col.data_ptr(),
                 unit_k.data_ptr(), b_tiles.data_ptr(), *idx, out.data_ptr(),
                 g, n_slots, u, r, kmax, nct, t, f,
                 *(knobs[k] for k in TUNE_KEYS), stream)
    _build.check(lib, err, "ragged_ell_spmm launch")
    with _build.count_lock:
        launches["float32" if f32 else "bfloat16"] += 1


def ragged_ell_rows(cols: torch.Tensor, vals: torch.Tensor,
                    tile_col: torch.Tensor, unit_k: torch.Tensor,
                    b_tiles: torch.Tensor, plan: SegmentPlan,
                    out: torch.Tensor, *, tune: dict = None,
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

    ``tune`` is the kernel's launch shape (``resolve_tune``; None = the
    defaults); every value gives the same bits.

    Every tensor must lie on ``device``. CPU tensors take the plain
    version (``ragged_ell_spmm_ref``, ``segment_sum``, then the add);
    CUDA tensors launch the kernel or raise.
    """
    what = "ragged_ell_rows"
    _build.tick(what)
    dev = resolve_device(device)
    cols, vals, tile_col, unit_k, b_tiles, _ = _checked(
        cols, vals, tile_col, unit_k, b_tiles, dev, what)
    g, u, r, _ = cols.shape
    f = b_tiles.shape[-1]
    resolve_tune(f, tune)          # unknown knobs raise on every device
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
            plan.live.shape[1], dev, tune)
    return out


def ragged_ell_spmm(cols: torch.Tensor, vals: torch.Tensor,
                    tile_col: torch.Tensor, unit_k: torch.Tensor,
                    b_tiles: torch.Tensor, *, tune: dict = None,
                    device="cuda") -> torch.Tensor:
    """Per-unit ELL products over the concatenated ragged unit array.

    cols [(G,) U, R, Kmax] int32 (tile-local), vals [(G,) U, R, Kmax] f32
    or bf16, tile_col [(G,) U] int32, unit_k [(G,) U] int32, b_tiles
    [(G,) nct, T, F] f32 or bf16  ->  [(G,) U, R, F] f32. ONE launch
    covers every K width. Every tensor must lie on ``device``; CPU
    tensors take the plain version, CUDA tensors launch the kernel or
    raise. Indices must be in range (``cols < T``, ``tile_col < nct``):
    partitions guarantee it and ``Engine.register`` checks it on the
    host. ``tune`` as for ``ragged_ell_rows``.
    """
    _build.tick("ragged_ell_spmm")
    dev = resolve_device(device)
    cols, vals, tile_col, unit_k, b_tiles, grouped = _checked(
        cols, vals, tile_col, unit_k, b_tiles, dev, "ragged_ell_spmm")
    resolve_tune(b_tiles.shape[-1], tune)
    if dev.type == "cpu":
        out = ragged_ell_spmm_ref(cols, vals, tile_col, unit_k, b_tiles)
        return out if grouped else out[0]
    g, u, r, _ = cols.shape
    out = torch.empty((g, u, r, b_tiles.shape[-1]), dtype=torch.float32,
                      device=dev)
    _launch(cols, vals, tile_col, unit_k, b_tiles, None, out, u * r, dev,
            tune)
    return out if grouped else out[0]


def _fixed_kernel(vals_dtype, b_dtype):
    """The fixed-K kernel's C entry for these types."""
    suffix = type_suffix(instance_dtypes(vals_dtype, b_dtype))
    return _entry("ell_spmm", f"ell_spmm_rows_{suffix}",
                  [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
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


def _fixed_launch(cols, vals, tile_col, b_tiles, band, carry, out, n_slots,
                  n_rows, out_sg, dev) -> None:
    """One launch of the fixed-K kernel; ``band`` None = unit mode."""
    g, u, r, k = cols.shape
    _, nct, t, f = b_tiles.shape
    lib, fn = _fixed_kernel(vals.dtype, b_tiles.dtype)
    f32 = instance_dtypes(vals.dtype, b_tiles.dtype) == ("float32",) * 2
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
    with _build.count_lock:
        fixed_k_launches["float32" if f32 else "bfloat16"] += 1


def ell_spmm_rows(cols: torch.Tensor, vals: torch.Tensor,
                  tile_col: torch.Tensor, b_tiles: torch.Tensor,
                  band: BandPlan, out: torch.Tensor,
                  carry: torch.Tensor = None, *, device="cuda"
                  ) -> torch.Tensor:
    """One class band's ELL rows, added onto ``out`` in place.

    cols/vals [G, U_b, R, K] (int32 tile-local / f32 or bf16; views of
    the ragged slab, ``ell_buckets``, read in place), tile_col
    [G, U_b] int32, b_tiles [G, nct, T, F] f32 or bf16, ``band`` the band's
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
    _build.tick(what)
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
    if g and u and r and f:
        _fixed_launch(cols, vals, tile_col, b_tiles, None, None, out, u * r,
                      0, out.stride(0), dev)
    return out if grouped else out[0]
