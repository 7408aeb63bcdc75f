"""Launch pass — structural proofs over the fixture forward as it runs.

The port's counterpart of ``repro.analysis.static.jaxpr_pass``. JAX
traces the dispatch into a jaxpr that the reference walks without
running it; PyTorch runs eagerly, so this pass runs the engine's real
executor (``ExecutorCache.gcn`` over the fixture graph) once and watches
it three ways: the kernel wrappers' call counters
(``repro_torch.kernels.ops.entry_counts``, which tick on every device),
every aten op the forward dispatches (a ``TorchDispatchMode``), and, on
a card, a ``torch.profiler`` trace of the device. It checks:

- **single-launch**: the "ragged" dispatch makes, per GCN layer, exactly
  ONE ``ragged_ell_rows`` call, one dense-engine (``bsr_spmm_rows``)
  call and one COO-engine (``coo_rows``) call where the class holds COO
  entries, and no fixed-K ELL call (counters); on a card also exactly
  one ``ell_rows_kernel``, one ``bsr_rows_kernel`` and one
  ``coo_rows_kernel`` per layer, no ``ell_band_kernel``, and none of the
  ops the COO engine ran before its kernel (``segment_reduce``, a
  ``gather``), in the profile.
- **no-host-sync**: no op that reads a device value on the host
  (``item``, ``nonzero``, ``masked_select``, ``unique``, a copy to the
  CPU) inside the forward; on a card also no stream/device/event
  synchronize, no synchronous ``cudaMemcpy`` and no device-to-host copy
  in the profiled window.
- **dtype/shape flow**: the executor runs at exactly the shapes
  ``prepare_x`` produces (class-padded input rows), emits float32
  logits of the class's padded row count, and no other floating dtype
  appears in any op of the forward; every member's true ``n_rows`` is
  covered by the class output.
- **sentinel-safety**: (a) layout, as the reference's
  ``check_sentinel_layout``: the sentinel row is ``n_padded_rows`` and
  dead units and masked lanes carry only zeros; (b) dead lanes: the
  forward is run again with every masked lane's value (kk >= unit_k)
  set to NaN, and the logits must stay bitwise-equal. The mask sits on
  the values, so a masked lane never reaches a sum: on the CPU this runs
  the kernels' plain versions, on a card the kernels.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.static.report import Finding
from repro_torch.core.formats import to_numpy
from repro_torch.kernels import ops

# aten ops that read a device value on the host (a sync on a card).
SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::item", "aten::is_nonzero",
    "aten::nonzero", "aten::masked_select", "aten::_unique",
    "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive",
    "aten::equal",
})
# host-side CUDA runtime calls that wait for the card
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
FLOAT_OK = frozenset({torch.float32})

# the GAT's wrappers and kernels (``core.gat``), one call of each a layer
GAT_WRAPPERS = ("gat_row_stats", "gat_edge_coef", "bsr_spmm_rows_heads",
                "ragged_ell_rows_heads", "coo_rows")
GAT_KERNELS = ("gat_row_stats_kernel", "gat_edge_coef_kernel",
               "bsr_heads_kernel", "ell_rows_heads_kernel",
               "coo_rows_heads_kernel")
RAGGED_WRAPPER = "ragged_ell_rows"
DENSE_WRAPPER = "bsr_spmm_rows"
COO_WRAPPER = "coo_rows"
FIXED_WRAPPERS = ("ell_spmm_rows", "ell_spmm")
RAGGED_KERNEL = "ell_rows_kernel"
DENSE_KERNEL = "bsr_rows_kernel"
COO_KERNEL = "coo_rows_kernel"
FIXED_KERNEL = "ell_band_kernel"
# the library kernels of the COO engine's plain chain (torch.gather,
# index_select, segment_reduce), which the served forward no longer runs
COO_PLAIN_KERNELS = ("segment_reduce", "gather")


class OpRecorder(TorchDispatchMode):
    """Every aten op dispatched inside the mode: (name, output dtypes,
    output devices, input devices)."""

    def __init__(self):
        super().__init__()
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        ins = [a for a in list(args) + list((kwargs or {}).values())
               if isinstance(a, torch.Tensor)]
        self.ops.append((
            func.name().split(".")[0],
            [o.dtype for o in outs if isinstance(o, torch.Tensor)],
            {o.device.type for o in outs if isinstance(o, torch.Tensor)},
            {a.device.type for a in ins}))
        return out


# --------------------------------------------------------------- checks -----

def check_single_launch(counts: dict, n_layers: int, label: str = "gcn",
                        *, has_coo: bool = False) -> List[Finding]:
    """Ragged dispatch: per layer one ragged ELL call, one dense-engine
    call and, where the class holds COO entries (``has_coo``), one
    COO-engine call, and no fixed-K call (wrapper call counters)."""
    findings: List[Finding] = []

    def err(msg):
        findings.append(Finding("launch", "single-launch", "error", label,
                                msg))

    if counts.get(RAGGED_WRAPPER, 0) != n_layers:
        err(f"expected {n_layers} {RAGGED_WRAPPER} call(s) (one per "
            f"SpMM), counted {counts.get(RAGGED_WRAPPER, 0)}: {counts}")
    if counts.get(DENSE_WRAPPER, 0) != n_layers:
        err(f"expected {n_layers} dense-engine {DENSE_WRAPPER} call(s), "
            f"counted {counts.get(DENSE_WRAPPER, 0)}: {counts}")
    want = n_layers if has_coo else 0
    if counts.get(COO_WRAPPER, 0) != want:
        err(f"expected {want} COO-engine {COO_WRAPPER} call(s), counted "
            f"{counts.get(COO_WRAPPER, 0)}: {counts}")
    fixed = sum(counts.get(k, 0) for k in FIXED_WRAPPERS)
    if fixed:
        err(f"{fixed} fixed-K ELL call(s) in ragged mode: {counts}")
    return findings


def check_profile(kernels: dict, runtime: dict, n_layers: int, calls: int,
                  has_dense: bool, label: str = "gcn", *,
                  has_coo: bool = False) -> List[Finding]:
    """A card's profile of ``calls`` forwards: kernel launches by name
    (``kernels``), and the host's CUDA runtime calls inside the forwards
    and the device's copies by name (``runtime``). ``has_coo``: the
    class holds COO entries, one ``coo_rows_kernel`` a layer."""
    findings: List[Finding] = []
    want = {RAGGED_KERNEL: n_layers * calls,
            DENSE_KERNEL: n_layers * calls if has_dense else 0,
            COO_KERNEL: n_layers * calls if has_coo else 0,
            FIXED_KERNEL: 0, **dict.fromkeys(COO_PLAIN_KERNELS, 0)}
    got = {k: sum(n for name, n in kernels.items() if k in name)
           for k in want}
    if got != want:
        findings.append(Finding(
            "launch", "single-launch", "error", label,
            f"profiled kernels over {calls} forward(s): {got}, want {want}"))
    syncs = {name: n for name, n in runtime.items()
             if name in SYNC_CALLS or "DtoH" in name}
    if syncs:
        findings.append(Finding(
            "launch", "no-host-sync", "error", label,
            f"host synchronization inside the profiled forward: {syncs}"))
    return findings


def check_no_host_sync(ops_seen: list, label: str) -> List[Finding]:
    hits = sorted({name for name, _, out_dev, in_dev in ops_seen
                   if name in SYNC_OPS
                   or ("cuda" in in_dev and out_dev == {"cpu"})})
    return [Finding(
        "launch", "no-host-sync", "error", label,
        f"{name} inside the forward reads a device value on the host: "
        f"every async dispatch would wait for the card")
        for name in hits]


def check_dtype_flow(ops_seen: list, x: torch.Tensor, y: torch.Tensor, *,
                     n_in_rows: int, n_out_rows: int, f_out: int,
                     n_rows: int, label: str) -> List[Finding]:
    findings: List[Finding] = []

    def err(rule, msg):
        findings.append(Finding("launch", rule, "error", label, msg))

    bad = sorted({f"{name} -> {dt}" for name, dts, _, _ in ops_seen
                  for dt in dts
                  if (dt.is_floating_point or dt.is_complex)
                  and dt not in FLOAT_OK})
    if bad:
        err("dtype-flow", f"non-float32 floating values in the forward "
            f"(breaks f32 kernel parity): {bad[:5]}")
    if tuple(x.shape)[0] != n_in_rows or x.dtype != torch.float32:
        err("shape-flow", f"executor input {tuple(x.shape)} {x.dtype}: "
            f"prepare_x should give {n_in_rows} float32 rows")
    if tuple(y.shape) != (n_out_rows, f_out):
        err("shape-flow", f"executor output {tuple(y.shape)} != "
            f"class-padded ({n_out_rows}, {f_out})")
    elif y.dtype != torch.float32:
        err("dtype-flow", f"executor output dtype {y.dtype}, want float32")
    if n_rows > n_out_rows:
        err("shape-flow", f"true n_rows {n_rows} exceeds the class output's "
            f"{n_out_rows} rows: the unpad slice truncates live rows")
    return findings


def check_sentinel_layout(handle) -> List[Finding]:
    """Static layout facts the ELL reduction's sentinel drop relies on."""
    findings: List[Finding] = []
    loc = f"graph:{handle.name}"

    def err(msg):
        findings.append(Finding("launch", "sentinel-safety", "error",
                                loc, msg))

    meta = handle.padded_meta
    if meta.ell_sentinel_row != meta.n_padded_rows:
        err(f"sentinel row {meta.ell_sentinel_row} != n_padded_rows "
            f"{meta.n_padded_rows}: padding writes would land INSIDE "
            f"the live slice")
    if handle.meta.n_rows > meta.n_padded_rows:
        err(f"true n_rows {handle.meta.n_rows} exceeds class-padded "
            f"rows {meta.n_padded_rows}: the unpad slice truncates "
            f"live rows")
    ell = handle.part.ell
    uk = to_numpy(ell.unit_k)
    if uk.size:
        rows = to_numpy(ell.rows)
        vals = to_numpy(ell.vals)
        dead = uk == 0
        if dead.any() and not (rows[dead] == meta.ell_sentinel_row).all():
            err("a dead unit (unit_k==0) targets a non-sentinel row")
        kmax = vals.shape[-1]
        kk = np.arange(kmax)[None, None, :]
        padded_lane = kk >= uk[:, None, None]
        if vals[np.broadcast_to(padded_lane, vals.shape)].any():
            err("non-zero values in masked lanes (kk >= unit_k): fused "
                "dispatch bitwise parity relies on zero padding")
        live_rows = rows[~dead] if (~dead).any() else rows[:0]
        if live_rows.size and (live_rows.max() > meta.ell_sentinel_row
                               or live_rows.min() < 0):
            err("live unit row ids outside [0, sentinel]")
    return findings


def nan_masked_lanes(part):
    """``part`` with every masked ELL lane's value (kk >= unit_k) NaN,
    and the number of such lanes."""
    ell = part.ell
    kk = torch.arange(ell.vals.shape[-1], device=ell.vals.device)
    masked = (kk >= ell.unit_k[..., None, None]).expand_as(ell.vals)
    vals = ell.vals.masked_fill(masked, float("nan"))
    return part._replace(ell=ell._replace(vals=vals)), int(masked.sum())


def check_dead_lanes(fn, handle, x, y, label: str) -> List[Finding]:
    """Dead-lane proof by perturbation: NaN in every masked lane must
    leave the logits bitwise-equal."""
    part, n_masked = nan_masked_lanes(handle.part)
    if not n_masked:
        return [Finding("launch", "sentinel-safety", "error", label,
                        "the class has no masked ELL lane: cannot run the "
                        "dead-lane proof")]
    y_nan = fn(part, x, handle.weights, handle.plan)
    same = torch.equal(torch.isnan(y_nan), torch.isnan(y)) and bool(
        (y_nan.view(torch.int32) == y.view(torch.int32))[
            ~torch.isnan(y)].all())
    if same:
        return []
    return [Finding("launch", "sentinel-safety", "error", label,
                    f"NaN in the {n_masked} masked ELL lanes (kk >= unit_k) "
                    "changed the logits: a padded lane reaches a sum — is "
                    "the value mask intact?")]


# ------------------------------------------------------ repo-level run -----

# The profiler now and then loses some or all of a step's device events
# (seen on an H100), and a lost kernel would read as a missing launch.
# The launches a forward makes are fixed by the host, so two traces in
# a row that agree are taken as the measurement.
PROFILE_TRIES = 4


def profile_forward(run, calls: int = 2) -> tuple:
    """(kernel launches by name, CUDA runtime calls made inside the
    forwards and device copies, by name) of ``calls`` runs of ``run`` on
    a card (``_profile_once``): profiled until two traces in a row hold
    the same kernel launches, not none, up to ``PROFILE_TRIES`` traces.
    When none agree the last trace is returned, and the checks run on
    it as they would on any other."""
    last = None
    for _ in range(PROFILE_TRIES):
        kernels, runtime = _profile_once(run, calls)
        if kernels and kernels == last:
            break
        last = kernels
    return kernels, runtime


def _profile_once(run, calls: int) -> tuple:
    """One profile for ``profile_forward``: the second step of a
    ``torch.profiler`` schedule, the first (the same calls) a discarded
    warm-up, since the first kernels after the profiler starts may go
    unrecorded. The step's closing synchronize lies outside the
    forwards' ``record_function`` window and is not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(list(p.events()))
                 ) as prof:
        for _ in range(2):
            with record_function("lint.forward"):
                for _ in range(calls):
                    run()
            torch.cuda.synchronize()
            prof.step()
    events = traced[-1]
    window = [e.time_range for e in events if e.name == "lint.forward"
              and e.device_type != DeviceType.CUDA]
    kernels, runtime = {}, {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("ProfilerStep") or e.name == "lint.forward":
                continue       # annotations span the step on the device
            into = runtime if ("Memcpy" in e.name
                               or "Memset" in e.name) else kernels
            into[e.name] = into.get(e.name, 0) + 1
        elif e.name.startswith("cuda") and any(
                w.start <= e.time_range.start <= w.end for w in window):
            runtime[e.name] = runtime.get(e.name, 0) + 1
    return kernels, runtime


def run_launch_pass(engine=None, name: str = "lint-fixture", *,
                    device="cuda") -> List[Finding]:
    """Repo-level entry: run the fixture engine's "ragged" dispatch path
    once and check every structural invariant; on a card, also profile
    it. ``engine`` None builds the fixture engine on ``device``."""
    from repro_torch.analysis.static.fixtures import fixture_engine, fixture_x
    if engine is None:
        engine = fixture_engine(device=device)
    h = engine.handle(name)
    w_shapes = tuple(tuple(w.shape) for w in h.weights)
    f_in = int(h.weights[0].shape[0])
    fn = engine.executors.gcn(h.sclass, f_in, w_shapes)
    x = engine.prepare_x(name, fixture_x(h.meta.n_cols, f_in))
    n_layers = len(h.weights)
    label = "gcn-executor"
    fn(h.part, x, h.weights, h.plan)          # build and warm outside
    rec = OpRecorder()
    ops.reset_entry_counts()
    with rec:
        y = fn(h.part, x, h.weights, h.plan)
    counts = ops.entry_counts()
    has_coo = bool(h.sclass.coo_nnz)
    findings = check_single_launch(counts, n_layers, has_coo=has_coo)
    findings += check_no_host_sync(rec.ops, label)
    findings += check_dtype_flow(
        rec.ops, x, y, n_in_rows=h.sclass.n_col_tiles * h.sclass.tile,
        n_out_rows=h.padded_meta.n_padded_rows,
        f_out=int(h.weights[-1].shape[1]), n_rows=h.meta.n_rows,
        label=label)
    findings += check_sentinel_layout(h)
    findings += check_dead_lanes(fn, h, x, y, label)
    if engine.device.type == "cuda":
        calls = 2
        kernels, runtime = profile_forward(
            lambda: fn(h.part, x, h.weights, h.plan), calls)
        findings += check_profile(kernels, runtime, n_layers, calls,
                                  bool(h.sclass.n_dense_tiles), label,
                                  has_coo=has_coo)
    return findings


def check_gat_launches(counts: dict, n_layers: int, has_coo: bool,
                       label: str = "gat") -> List[Finding]:
    """A GAT forward of multi-head layers: per layer one call of each of
    ``GAT_WRAPPERS`` (the COO engine's where the class holds COO
    entries), none of the single-value ELL wrappers and no fixed-K
    call (wrapper call counters)."""
    want = {w: n_layers for w in GAT_WRAPPERS}
    want["coo_rows"] = n_layers if has_coo else 0
    want[RAGGED_WRAPPER] = 0
    want.update(dict.fromkeys(FIXED_WRAPPERS, 0))
    got = {w: counts.get(w, 0) for w in want}
    if got == want:
        return []
    return [Finding("launch", "single-launch", "error", label,
                    f"expected calls {want}, counted {got}")]


def check_gat_profile(kernels: dict, n_layers: int, calls: int,
                      has_coo: bool, label: str = "gat") -> List[Finding]:
    """A card's profile of ``calls`` GAT forwards: one launch of each of
    ``GAT_KERNELS`` a layer (the COO one where the class holds COO
    entries), and none of the single-value ELL kernel."""
    want = {k: n_layers * calls for k in GAT_KERNELS}
    want["coo_rows_heads_kernel"] = n_layers * calls if has_coo else 0
    got = {k: sum(n for name, n in kernels.items() if k in name)
           for k in want}
    got[RAGGED_KERNEL + "<"] = sum(n for name, n in kernels.items()
                                   if RAGGED_KERNEL + "<" in name)
    want[RAGGED_KERNEL + "<"] = 0
    if got == want:
        return []
    return [Finding("launch", "single-launch", "error", label,
                    f"profiled launches {got}, want {want}")]


def run_gat_launch_pass(engine=None, name: str = "lint-fixture-gat", *,
                        device="cuda") -> List[Finding]:
    """The GAT's dispatch (``ExecutorCache.gat`` over the fixture graph
    as a GAT, ``fixtures.fixture_gat_engine``): one call of each engine's
    multi-head wrapper and of the edge-coefficient wrappers a layer, no
    host sync, float32 throughout, the class's padded rows out with
    every padding row 0; on a card the profile's launches."""
    from repro_torch.analysis.static.fixtures import (fixture_gat_engine,
                                                      fixture_x)
    if engine is None:
        engine = fixture_gat_engine(device=device)
    h = engine.handle(name)
    f_in = int(h.weights[0].shape[0])
    fn = engine.executors.gat(h.sclass, f_in, tuple(
        tuple(w.shape) for w in h.weights), h.gat)
    x = engine.prepare_x(name, fixture_x(h.meta.n_cols, f_in))
    n_layers = len(h.gat.heads)
    label = "gat-executor"

    def run():
        return fn(h.part, x, h.weights, h.plan, h.rows)

    run()                                     # build and warm outside
    rec = OpRecorder()
    ops.reset_entry_counts()
    with rec:
        y = run()
    has_coo = bool(h.sclass.coo_nnz)
    findings = check_gat_launches(ops.entry_counts(), n_layers, has_coo,
                                  label)
    findings += check_no_host_sync(rec.ops, label)
    findings += check_dtype_flow(
        rec.ops, x, y, n_in_rows=h.sclass.n_col_tiles * h.sclass.tile,
        n_out_rows=h.padded_meta.n_padded_rows, f_out=h.gat.out_width,
        n_rows=h.meta.n_rows, label=label)
    if not bool(torch.isfinite(y).all()) or bool(
            (y[h.meta.n_rows:] != 0).any()):
        findings.append(Finding("launch", "sentinel-safety", "error", label,
                                "class padding rows of the GAT's logits "
                                "are not all 0 (or a logit is not finite)"))
    if engine.device.type == "cuda":
        calls = 2
        kernels, _ = profile_forward(run, calls)
        findings += check_gat_profile(kernels, n_layers, calls, has_coo,
                                      label)
    return findings
