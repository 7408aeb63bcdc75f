"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository's ``src/`` next to this file. It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. drives the main path: registers cora, citeseer and pubmed at full
     size with the paper's 2-layer GCN (hidden 128, seeded Glorot
     weights), then serves each graph one ``infer`` and one 4-request
     ``serve_group``, with the kernels' launch counters set to 0 just
     before and read just after;
  4. checks the main path: logits finite and of the right shape, within
     tolerance of the port's plain "torch" backend on the same card,
     ``serve_group`` outputs matching per-request ``infer``, repeat runs
     bitwise-equal, and exactly one launch of each kernel per layer;
     profiles one ``infer`` per graph (``torch.profiler``): kernels and
     device ms per infer, the card's busy share, and the launches of the
     kernels named in ``PROFILE_NAMES`` (the ELL and BSR row kernels,
     gathers, ``segment_reduce`` and its scans, elementwise kernels);
  5. the serving front end over the main path's engine
     (``repro_torch.serving.RequestQueue``, host features as a user
     submits them, 4 requests per graph): serial on a worker thread,
     pipelined, two replica lanes on the one card, and under chaos (one
     poisoned request name quarantined by bisection; a hung dispatch
     reclaimed by the dispatch watchdog); results bitwise-equal to
     ``serve_group``, two launches of each kernel per batch, and each
     warm latency sample at least its dispatch's device time; prints
     one ``{"serving": ...}`` line;
  6. a reordered graph on the main path: cora at full size, reordered by
     its planted communities (``reorder(csr, "labels", ...)``), served
     one ``infer`` with the launches of the main path and logits within
     tolerance of the plain backend and of the unreordered graph; its
     class has no dense tile, and ``bsr_spmm_rows`` on that empty dense
     part must give zeros without a launch;
  7. dispatch A/B: the same requests through ``Engine(ell_dispatch=d)``
     for the per-K dispatches "fused" and "loop" (one ``ell_spmm`` launch
     per class band per layer, which also sums the band onto rows and
     adds it onto the dense rows; no ``ragged_ell_spmm``); logits must
     equal the ragged dispatch's bit for bit, repeats bitwise; one
     ``infer`` of each is profiled beside the ragged dispatch's, and its
     ELL part must be the band kernels alone;
  8. lifecycle, on the "ragged" and the "fused" dispatch: three
     pubmed-shaped graphs of one shape class, served, then their class
     retired by a ``LifecycleManager`` window; the successors are
     tighter and at least one has fewer padded rows (so X·W and the
     dense-tile grid run at a new M), ``spmm`` is bitwise-equal across
     the retirement, ``infer`` within tolerance (bitwise equality
     printed), and a replica view serves a successor class as the
     engine does;
  9. the matmul path: the GCN's X·W products of the main path through
     ``kernels.ops.matmul`` (the ``tile_matmul`` kernel);
 10. holds each of the four kernels against its plain PyTorch version at
     the shapes its path gave it, and times kernel, plain version and one
     library call with CUDA events: for the ELL row kernels
     (``ragged_ell_rows``, and ``ell_spmm_rows`` band after band)
     ``torch.sparse.mm`` over a CSR of the rows with an entry, then
     ``index_add_`` onto them; ``torch.matmul`` for ``tile_matmul``
     (every block configuration timed, all bitwise-equal); for the dense
     engine (``bsr_spmm_rows``: the BSR products summed per row tile in
     the kernel) ``torch.bmm`` on gathered B tiles followed by
     ``segment_sum``, with ``torch.bmm`` alone beside it. Each folded
     kernel must equal its per-tile / per-unit kernel followed by
     ``segment_sum`` (for the ELL rows also the add onto the dense rows;
     for the bands also the "loop" chain of per-bucket sums) bit for bit;
 11. prints one ``{"kernels": [...]}`` line (with each kernel's ptxas
     registers and spills) and, last, the ``{"ok": true, "device": ...}``
     line.

Any failed check exits non-zero without the last line. Without CUDA, or
without the repository's sources, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): device memory rate and
# float32 outside the tensor cores (the kernels run FFMA, no TF32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# The paper's model, as in src/repro/configs/gcn_paper.py CONFIG:
# 2-layer GCN, hidden 128; the output width is the dataset's n_classes.
HIDDEN = 128
GRAPHS = ("cora", "citeseer", "pubmed")
GROUP = 4
SEED = 0

KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)   # f32, one k order vs another
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)    # 1433-wide X·W, other sum order
# tile_matmul vs cuBLAS: |C - C_ref| <= atol + rtol * (|A| @ |B|), a
# multiple of the float32 rounding of K-term sums taken in two orders
MATMUL_TOL = dict(rtol=1e-5, atol=1e-6)
# The per-K A/B dispatches, and the pubmed scales (largest first) that
# land in one shape class for the lifecycle phase: pubmed@1.0 founds a
# 512 x 512-tile class; 0.78 and 0.71 (241 and 219 row tiles) join it,
# and its retirement moves them into a 256 x 256-tile successor.
AB_DISPATCHES = ("fused", "loop")
LIFECYCLE_SCALES = (1.0, 0.78, 0.71)
LIFECYCLE_DISPATCHES = ("ragged", "fused")
LAYERS = 2
# Serving phase: a deadline this long never closes a batch early, so each
# graph's GROUP requests close as one batch of GROUP (by size).
SERVE_DEADLINE_MS = 60_000.0
SERVE_TIMEOUT_S = 120.0
TIMING_REPS = 30
GRAPH_CALLS = 20
# device kernels counted by name in the profile of one infer
PROFILE_NAMES = {"bsr_rows_kernel": "bsr_rows_kernel",
                 "ell_rows_kernel": "ell_rows_kernel",
                 "ell_band_kernel": "ell_band_kernel",
                 "segment_reduce": "segment_reduce",
                 "scan": "scan",
                 "index_select": "vectorized_gather",
                 "elementwise": "elementwise_kernel"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def max_err(a, b) -> float:
    return float((a - b).abs().max().item()) if a.numel() else 0.0


def close(a, b, rtol, atol) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all().item())


def matmul_close(torch, got, want, a, b) -> bool:
    bound = MATMUL_TOL["atol"] + MATMUL_TOL["rtol"] * torch.matmul(
        a.abs(), b.abs())
    return bool(((got - want).abs() <= bound).all().item())


def glorot(rng, fan_in: int, fan_out: int) -> np.ndarray:
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)


def call_ms(torch, fn) -> float:
    """Median CUDA-event time of one call issued from Python: the card
    waits for the host between the events, so this includes the
    wrapper's host overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn) -> float:
    """Device time of one call: GRAPH_CALLS calls captured in one CUDA
    graph, replayed TIMING_REPS times; median per call. Replaying keeps
    host overhead out, so this is the time the card spends."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_CALLS)
    return statistics.median(times)


def wall_ms(torch, fn) -> float:
    """Median host time of a call that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops,
                                                          "operations")


def ptxas_summary(log: str) -> list:
    """One line per kernel of an nvcc ``-Xptxas -v`` log, as ptxas reports
    it: the entry's (mangled) name, its registers, static shared memory
    and spills."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


# ------------------------------------------------------------ main path ----
def main_path(torch):
    """Register the three graphs and serve each one infer and one group.

    Returns (engine, per-graph records, launch counts of the run).
    """
    from repro_torch.data.graphs import PAPER_DATASETS, make_paper_dataset
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED)
    engine = Engine(device="cuda")
    graphs = {}
    ops.reset_launch_counts()
    for name in GRAPHS:
        st = PAPER_DATASETS[name]
        csr, x0, _, _ = make_paper_dataset(name, scale=1.0, seed=SEED)
        ws = [glorot(rng, st.n_features, HIDDEN),
              glorot(rng, HIDDEN, st.n_classes)]
        t0 = time.perf_counter()
        engine.register(name, csr, weights=ws)
        reg_s = time.perf_counter() - t0
        xs = [x0] + [(rng.random(x0.shape) < 0.05).astype(np.float32)
                     for _ in range(GROUP - 1)]
        c0 = ops.launch_counts()
        y_infer = engine.infer(name, xs[0])
        torch.cuda.synchronize()
        c1 = ops.launch_counts()
        y_group = engine.serve_group([(name, x) for x in xs])
        torch.cuda.synchronize()
        c2 = ops.launch_counts()
        graphs[name] = dict(
            csr=csr, n=csr.shape[0], classes=st.n_classes, ws=ws, xs=xs,
            register_s=reg_s, y_infer=y_infer, y_group=y_group,
            infer_launches={k: c1[k] - c0[k] for k in c0},
            group_launches={k: c2[k] - c1[k] for k in c0})
    return engine, graphs, ops.launch_counts()


def check_main_path(torch, engine, graphs, counts) -> list:
    from repro_torch.engine import Engine

    problems = []
    ref = Engine(device="cuda", backend="torch")
    layers = LAYERS
    for name, g in graphs.items():
        ref.register(name, g["csr"], weights=g["ws"])
        want_shape = (g["n"], g["classes"])
        outs = [g["y_infer"]] + list(g["y_group"])
        for y in outs:
            if tuple(y.shape) != want_shape:
                problems.append(f"{name}: logits shape {tuple(y.shape)}")
            if not bool(torch.isfinite(y).all()):
                problems.append(f"{name}: non-finite logits")
        for kind in ("infer_launches", "group_launches"):
            if g[kind] != {"bsr_spmm": layers, "ragged_ell_spmm": layers,
                           "ell_spmm": 0, "tile_matmul": 0}:
                problems.append(f"{name}: {kind} {g[kind]}, want one of "
                                f"each kernel per layer")
        y_ref = ref.infer(name, g["xs"][0])
        g["err_vs_torch"] = max_err(g["y_infer"], y_ref)
        if not close(g["y_infer"], y_ref, **LOGIT_TOL):
            problems.append(f"{name}: infer vs torch backend "
                            f"max_abs_err {g['err_vs_torch']}")
        solo = [engine.infer(name, x) for x in g["xs"]]
        g["err_group_vs_infer"] = max(max_err(a, b)
                                      for a, b in zip(g["y_group"], solo))
        g["group_bitwise_infer"] = all(torch.equal(a, b)
                                       for a, b in zip(g["y_group"], solo))
        if not all(close(a, b, **LOGIT_TOL)
                   for a, b in zip(g["y_group"], solo)):
            problems.append(f"{name}: serve_group vs infer max_abs_err "
                            f"{g['err_group_vs_infer']}")
        again = engine.serve_group([(name, x) for x in g["xs"]])
        if not (torch.equal(engine.infer(name, g["xs"][0]), g["y_infer"])
                and all(torch.equal(a, b)
                        for a, b in zip(again, g["y_group"]))):
            problems.append(f"{name}: repeat run not bitwise-equal")
        # host features (what a request brings) and features already on
        # the card (the forward alone)
        reqs = [(name, x) for x in g["xs"]]
        x_dev = torch.from_numpy(g["xs"][0]).cuda()
        g["infer_ms"] = wall_ms(torch, lambda: engine.infer(name, g["xs"][0]))
        g["infer_dev_ms"] = wall_ms(torch, lambda: engine.infer(name, x_dev))
        g["group_ms"] = wall_ms(torch, lambda: engine.serve_group(reqs))
    for k in ("bsr_spmm", "ragged_ell_spmm"):
        if counts[k] == 0:
            problems.append(f"{k} never launched on the main path")
    return problems


# ------------------------------------------------------------- serving ----
def _resolve(futs) -> tuple:
    """(results, errors) of ``futs``, each waited for at most
    ``SERVE_TIMEOUT_S``; a future that raised or timed out leaves None
    and its exception."""
    outs, errs = [], []
    for f in futs:
        try:
            outs.append(f.result(timeout=SERVE_TIMEOUT_S))
            errs.append(None)
        except Exception as e:     # noqa: BLE001 — reported as a problem
            outs.append(None)
            errs.append(e)
    return outs, errs


def _serve(torch, queue, reqs, on_done=None) -> tuple:
    """Start ``queue``, submit ``reqs`` (host features), wait for every
    future, stop the queue. Returns (results, errors, wall seconds,
    stats snapshot)."""
    t0 = time.perf_counter()
    queue.start()
    try:
        futs = []
        for i, (name, x) in enumerate(reqs):
            f = queue.submit(name, x)
            if on_done is not None:
                f.add_done_callback(lambda _, i=i: on_done(i))
            futs.append(f)
        outs, errs = _resolve(futs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        queue.stop()
    return outs, errs, wall, queue.stats.snapshot()


def _mode_record(snap, wall, **extra) -> dict:
    keep = ("arrivals", "completed", "batches", "batch_hist",
            "close_reasons", "p50_ms", "p99_ms", "mean_latency_ms",
            "deadline_misses", "dispatch_errors", "inflight_peak",
            "overlap_ratio", "staging_p50_ms", "device_p50_ms",
            "resilience")
    rec = {k: snap[k] for k in keep}
    if "replicas" in snap:
        rec["replicas"] = {k: snap["replicas"][k]
                           for k in ("count", "faults", "key_epochs")}
        rec["routed"] = {r: v["routed"] for r, v in
                         snap["replicas"]["per_replica"].items()}
    return dict(rec, wall_s=wall, **extra)


def serving_phase(torch, engine, graphs, smi: str) -> tuple:
    """The serving front end over the main path's "ragged" engine.

    Four modes, each a ``RequestQueue`` over ``engine`` with its worker
    thread started, fed the main path's requests as host numpy features
    (``GROUP`` per graph, so each graph's requests share one key and
    close as one batch), the launch counters set to 0 just before each
    mode and read just after:

      serial     ``RequestQueue(engine, target_batch=GROUP)``. Gates:
                 every future resolves; results bitwise-equal to the main
                 path's ``serve_group`` of the same members (``y_group``)
                 and within ``LOGIT_TOL`` of per-request ``infer``; two
                 launches (one per layer) of ``ragged_ell_spmm`` per
                 batch and of ``bsr_spmm`` per batch on a class with
                 dense tiles; ``stats()["serving"]["completed"]`` equals
                 the submissions; each warm latency sample at least the
                 device ms of its dispatch (CUDA events around
                 ``serve_group_async``), so the queue timed the dispatch
                 and not its enqueue;
      pipelined  ``pipelined=True, max_inflight=4, stage_workers=1``:
                 results bitwise-equal to serial, the same launches;
      replicas   ``replicas=2`` (two ``replica_view`` lanes, private
                 executor caches, one card), the requests twice: results
                 bitwise-equal to serial, each graph's futures resolved
                 in submit order, the same launches per batch;
      chaos      a ``ChaosInjector`` poisons one request name (an alias
                 of cora in cora's batch): that future raises
                 ``PoisonedRequest``, its batch-mates stay within
                 ``LOGIT_TOL`` of serial (bitwise equality printed);
                 then a pipelined queue whose first dispatch hangs: the
                 dispatch watchdog reclaims it, the retry resolves every
                 future (within ``LOGIT_TOL`` of serial, bitwise
                 printed).

    Also times a warm one-request ``serve_group`` with the features on
    the card per graph: the least of these is what
    ``Engine.LAUNCH_FLOOR_S`` states.

    Returns (problems, record).
    """
    from repro_torch.kernels import ops
    from repro_torch.serving import (NULL_INJECTOR, ChaosInjector,
                                     FaultPlan, FaultSpec, PoisonedRequest,
                                     RequestQueue)

    problems, record = [], dict(gpu=smi)
    names = list(graphs)
    reqs = [(name, x) for name in names for x in graphs[name]["xs"]]
    dense = {name: bool(engine.handle(name).sclass.n_dense_tiles)
             for name in names}

    def launch_problems(mode, counts, batches_by_graph):
        want = {"bsr_spmm": sum(LAYERS * n for g, n in
                                batches_by_graph.items() if dense[g]),
                "ragged_ell_spmm": LAYERS * sum(batches_by_graph.values()),
                "ell_spmm": 0, "tile_matmul": 0}
        if counts != want:
            return [f"serving {mode}: launches {counts}, want {want}"]
        return []

    def unresolved(mode, errs):
        bad = [repr(e) for e in errs if e is not None]
        return [f"serving {mode}: {len(bad)} futures failed: {bad[:3]}"] \
            if bad else []

    # -- serial, with each dispatch's device time and latency sample ----
    events, samples = [], []
    async_fn = engine.serve_group_async

    def timed(requests, prepared=None, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = async_fn(requests, prepared, **kw)
        end.record()
        events.append((start, end))
        return out

    engine.serve_group_async = timed
    try:
        queue = RequestQueue(engine, target_batch=GROUP,
                             default_deadline_ms=SERVE_DEADLINE_MS)
        observe = queue.latency.observe

        def record_sample(key, batch, dt_s=None, cold=False, **kw):
            samples.append((dt_s, cold))
            observe(key, batch, dt_s, cold, **kw)

        queue.latency.observe = record_sample
        ops.reset_launch_counts()
        serial, errs, wall, snap = _serve(torch, queue, reqs)
        counts = ops.launch_counts()
    finally:
        del engine.serve_group_async
    problems += unresolved("serial", errs)
    problems += launch_problems("serial", counts, {n: 1 for n in names})
    completed = engine.stats()["serving"]["completed"]
    if completed != len(reqs) or snap["batches"] != len(names):
        problems.append(f"serving serial: completed {completed}, batches "
                        f"{snap['batches']}; want {len(reqs)}, "
                        f"{len(names)}")
    bitwise, err_infer = True, 0.0
    for k, (name, x) in enumerate(reqs):
        y, want = serial[k], graphs[name]["y_group"][k % GROUP]
        if y is None:
            continue
        bitwise &= torch.equal(y, want)
        solo = engine.infer(name, x)
        err_infer = max(err_infer, max_err(y, solo))
        if not close(y, solo, **LOGIT_TOL):
            problems.append(f"serving serial {name}: vs infer max_abs_err "
                            f"{max_err(y, solo)}")
    if not bitwise:
        problems.append("serving serial: results not bitwise-equal to "
                        "serve_group of the same members")
    torch.cuda.synchronize()
    dev_ms = [start.elapsed_time(end) for start, end in events]
    lat_ms = [dt * 1e3 for dt, _ in samples]
    warm = [not cold for _, cold in samples]
    if len(dev_ms) != len(samples) or not all(warm) or any(
            lat < dev for lat, dev in zip(lat_ms, dev_ms)):
        problems.append(f"serving serial: latency samples {lat_ms} ms "
                        f"(warm {warm}) against dispatch device times "
                        f"{dev_ms} ms")
    record["serial"] = _mode_record(
        snap, wall, launches=counts, bitwise_vs_serve_group=bitwise,
        max_abs_err_vs_infer=err_infer, latency_samples_ms=lat_ms,
        dispatch_device_ms=dev_ms)

    # -- pipelined -------------------------------------------------------
    queue = RequestQueue(engine, target_batch=GROUP,
                         default_deadline_ms=SERVE_DEADLINE_MS,
                         pipelined=True, max_inflight=4, stage_workers=1)
    ops.reset_launch_counts()
    outs, errs, wall, snap = _serve(torch, queue, reqs)
    counts = ops.launch_counts()
    problems += unresolved("pipelined", errs)
    problems += launch_problems("pipelined", counts, {n: 1 for n in names})
    same = all(a is not None and b is not None and torch.equal(a, b)
               for a, b in zip(outs, serial))
    if not same:
        problems.append("serving pipelined: results not bitwise-equal to "
                        "serial")
    record["pipelined"] = _mode_record(snap, wall, launches=counts,
                                       bitwise_vs_serial=same)

    # -- two replica lanes on the one card, the requests twice -----------
    done_order = []
    queue = RequestQueue(engine, target_batch=GROUP,
                         default_deadline_ms=SERVE_DEADLINE_MS, replicas=2)
    ops.reset_launch_counts()
    outs, errs, wall, snap = _serve(torch, queue, reqs + reqs,
                                    on_done=done_order.append)
    counts = ops.launch_counts()
    problems += unresolved("replicas", errs)
    problems += launch_problems("replicas", counts, {n: 2 for n in names})
    same = all(a is not None and b is not None and torch.equal(a, b)
               for a, b in zip(outs, serial + serial))
    in_order = all(
        [i for i in done_order if reqs[i % len(reqs)][0] == name]
        == sorted(i for i in done_order if reqs[i % len(reqs)][0] == name)
        for name in names) and len(done_order) == 2 * len(reqs)
    if not (same and in_order):
        problems.append(f"serving replicas: bitwise vs serial {same}, "
                        f"per-key order kept {in_order}")
    record["replicas"] = _mode_record(snap, wall, launches=counts,
                                      bitwise_vs_serial=same,
                                      per_key_order=in_order)

    # -- chaos: a poisoned request name, then a hung dispatch ------------
    cora = graphs["cora"]
    alias = "cora~"
    engine.register(alias, cora["csr"], weights=cora["ws"])
    poison_reqs = [("cora", cora["xs"][0]), ("cora", cora["xs"][1]),
                   (alias, cora["xs"][2]), ("cora", cora["xs"][3])]
    inj = ChaosInjector(FaultPlan([FaultSpec(site="poison", at=0,
                                             member=2)]))
    queue = RequestQueue(engine, target_batch=GROUP,
                         default_deadline_ms=SERVE_DEADLINE_MS,
                         injector=inj, resilience=True)
    try:
        outs, errs, wall, snap = _serve(torch, queue, poison_reqs)
    finally:
        engine.attach_injector(NULL_INJECTOR)
    base = names.index("cora") * GROUP
    mates = [k for k in range(GROUP) if k != 2]
    poisoned = isinstance(errs[2], PoisonedRequest)
    mates_ok = all(outs[k] is not None and close(
        outs[k], serial[base + k], **LOGIT_TOL) for k in mates)
    mates_bitwise = all(outs[k] is not None and torch.equal(
        outs[k], serial[base + k]) for k in mates)
    if not (poisoned and mates_ok and all(errs[k] is None for k in mates)):
        problems.append(f"serving chaos poison: poisoned future raised "
                        f"{errs[2]!r}; batch-mates within LOGIT_TOL "
                        f"{mates_ok}, errors {[repr(e) for e in errs]}")
    record["chaos_poison"] = _mode_record(
        snap, wall, poisoned_raised=poisoned, mates_within_tol=mates_ok,
        mates_bitwise_vs_serial=mates_bitwise, fired=inj.fired())

    base = names.index("pubmed") * GROUP
    hang_reqs = reqs[base:base + GROUP]
    inj = ChaosInjector(FaultPlan([FaultSpec(site="hang", at=0)]))
    queue = RequestQueue(engine, target_batch=GROUP,
                         default_deadline_ms=SERVE_DEADLINE_MS,
                         pipelined=True, injector=inj, resilience=True)
    try:
        outs, errs, wall, snap = _serve(torch, queue, hang_reqs)
    finally:
        engine.attach_injector(NULL_INJECTOR)
    ok = all(e is None for e in errs) and all(
        close(y, serial[base + k], **LOGIT_TOL) for k, y in enumerate(outs))
    hang_bitwise = ok and all(torch.equal(y, serial[base + k])
                              for k, y in enumerate(outs))
    fires = snap["resilience"]["watchdog_fires"]
    if not ok or fires < 1 or queue.inflight():
        problems.append(f"serving chaos hang: watchdog fires {fires}, "
                        f"errors {[repr(e) for e in errs]}, within "
                        f"LOGIT_TOL {ok}, in flight {queue.inflight()}")
    record["chaos_hang"] = _mode_record(
        snap, wall, within_tol=ok, bitwise_vs_serial=hang_bitwise,
        fired=inj.fired())

    # -- the latency prior's floor: warm one-request dispatches ----------
    one = {}
    for name in names:
        x_dev = torch.from_numpy(graphs[name]["xs"][0]).cuda()
        one[name] = wall_ms(torch, lambda: engine.serve_group([(name,
                                                                 x_dev)]))
    record["one_request_serve_group_dev_x_ms"] = one
    record["launch_floor_ms"] = engine.LAUNCH_FLOOR_S * 1e3
    return problems, record


def reordered_phase(torch, engine, graphs) -> tuple:
    """One more graph on the main path: cora at full size, reordered by
    its planted communities (``reorder(csr, "labels", labels=
    make_paper_dataset.last_labels)``, the paper workload's first step),
    registered on the main path's engine and served one ``infer``, with
    the launch counters set to 0 just before and read just after.

    Gates: the main path's launches, one per layer of each engine that
    the graph's shape class has (the reordering moves all of cora's
    dense tiles into the ELL engine, so its class may have none, and
    then ``bsr_spmm`` has no launch), and nothing else; logits finite,
    of the graph's shape, within ``LOGIT_TOL`` of the plain "torch"
    backend on the same reordered graph and of the main path's
    unreordered cora logits (same weights and features; the engine
    returns rows in the graph's own order).

    Then ``bsr_spmm_rows`` once on the dense part of the graph's class,
    which has no tile: zeros of the row tiles' shape, and no launch.

    Returns (problems, record, launch counts of the run).
    """
    from repro_torch.core.formats import b_tiles_of, plan_to, stack_plans
    from repro_torch.core.reorder import bandwidth, reorder
    from repro_torch.data.graphs import make_paper_dataset
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.kernels.bsr_spmm import bsr_spmm_rows

    g = graphs["cora"]
    csr, _, _, _ = make_paper_dataset("cora", scale=1.0, seed=SEED)
    labels = make_paper_dataset.last_labels
    name = "cora@labels"
    t0 = time.perf_counter()
    engine.register(name, csr, reorder="labels", labels=labels,
                    weights=g["ws"])
    register_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    y = engine.infer(name, g["xs"][0])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    problems = []
    sc = engine.handle(name).sclass
    want = {"bsr_spmm": LAYERS if sc.n_dense_tiles else 0,
            "ragged_ell_spmm": LAYERS if sc.ell_units else 0,
            "ell_spmm": 0, "tile_matmul": 0}
    if counts != want or counts["ragged_ell_spmm"] == 0:
        problems.append(f"{name}: launches {counts}, want {want}")
    if tuple(y.shape) != (g["n"], g["classes"]) or not bool(
            torch.isfinite(y).all()):
        problems.append(f"{name}: logits {tuple(y.shape)}, finite "
                        f"{bool(torch.isfinite(y).all())}")
    ref = Engine(device="cuda", backend="torch")
    ref.register(name, csr, reorder="labels", labels=labels, weights=g["ws"])
    y_ref = ref.infer(name, g["xs"][0])
    for what, other in (("torch backend", y_ref),
                        ("unreordered graph", g["y_infer"])):
        if not close(y, other, **LOGIT_TOL):
            problems.append(f"{name} vs {what}: max_abs_err "
                            f"{max_err(y, other)}")
    h = engine.handle(name)
    b = torch.matmul(engine.prepare_x(name, g["xs"][0]), h.weights[0])
    c0 = ops.launch_counts()["bsr_spmm"]
    empty = bsr_spmm_rows(
        h.part.dense.tiles[None], h.part.dense.tile_col[None],
        b_tiles_of(b[None], sc.to_meta()).contiguous(),
        plan_to(stack_plans([h.host_plan]), b.device).dense,
        device=b.device)
    torch.cuda.synchronize()
    empty_ok = (not sc.n_dense_tiles
                and tuple(empty.shape) == (1, sc.n_row_tiles, sc.tile,
                                           b.shape[1])
                and not bool(empty.any())
                and ops.launch_counts()["bsr_spmm"] == c0)
    if not empty_ok:
        problems.append(f"{name}: bsr_spmm_rows on the class's dense part "
                        f"({sc.n_dense_tiles} tiles) gave "
                        f"{tuple(empty.shape)}, nonzero "
                        f"{int(empty.count_nonzero())}, launches "
                        f"{ops.launch_counts()['bsr_spmm'] - c0}")
    record = dict(graph=name, register_s=register_s, launches=counts,
                  empty_dense_zeros=empty_ok,
                  err_vs_torch=max_err(y, y_ref),
                  err_vs_unreordered=max_err(y, g["y_infer"]),
                  bandwidth=[bandwidth(csr), bandwidth(reorder(
                      csr, "labels", labels=labels)[0])],
                  shape_class=sc.summary(),
                  main_path_class=engine.handle("cora").sclass.summary())
    return problems, record, counts


def profile_calls(torch, fn, calls: int = 5) -> dict:
    """Device time of one call of ``fn``, from a ``torch.profiler`` trace
    of ``calls`` calls: kernels per call, device ms per call, the
    device's busy share of the traced wall time, launches per call of the
    kernels in ``PROFILE_NAMES``, and the kernels that take the most
    device time. The trace is the profiler's second step: the first, a
    warm-up step of the same calls, is discarded, because kernels of the
    first calls after the profiler starts may go unrecorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(list(p.events()))
                 ) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    per_kernel, launches = {}, 0
    by_name = dict.fromkeys(PROFILE_NAMES, 0)
    for e in traced[-1]:
        # the step's own annotation spans the step on the device too
        if (e.device_type == DeviceType.CUDA
                and not e.name.startswith("ProfilerStep")):
            launches += 1
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
            for key, pattern in PROFILE_NAMES.items():
                by_name[key] += pattern in e.name.lower()
    busy_us = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return dict(kernels_per_infer=launches / calls,
                device_ms_per_infer=busy_us / calls / 1e3,
                busy_share=busy_us / wall_us if wall_us else 0.0,
                launches_per_infer={k: v / calls for k, v in by_name.items()},
                top=[[k[:60], v / calls / 1e3] for k, v in top])


# -------------------------------------------------------- dispatch A/B ----
def dispatch_ab(torch, graphs) -> tuple:
    """Serve the main path's requests through ``Engine(ell_dispatch=d)``
    for each per-K dispatch, with the launch counters set to 0 just
    before each dispatch's run and read just after; then profile one
    ``infer`` per graph beside the ragged dispatch's profile
    (``graphs[name]["profile"]``).

    Gates: one ``ell_spmm`` launch per class band per layer and no
    ``ragged_ell_spmm``; logits bit for bit equal to the ragged
    dispatch's; repeats bitwise; in the profile, band kernels and no
    ``ell_rows_kernel`` on the ELL part, and no gather,
    ``segment_reduce``, scan or elementwise kernel beyond the ragged
    dispatch's (``profile_problems``).

    Returns (problems, per-(dispatch, graph) records, launch counts of
    each dispatch's run).
    """
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops

    problems, rows, per_dispatch = [], [], {}
    for d in AB_DISPATCHES:
        engine = Engine(device="cuda", ell_dispatch=d)
        register_s = {}
        for name, g in graphs.items():
            t0 = time.perf_counter()
            engine.register(name, g["csr"], weights=g["ws"])
            register_s[name] = time.perf_counter() - t0
        outs = {}
        ops.reset_launch_counts()
        for name, g in graphs.items():
            bands = len(engine.handle(name).sclass.bands)
            want = {"bsr_spmm": LAYERS, "ragged_ell_spmm": 0,
                    "ell_spmm": LAYERS * bands, "tile_matmul": 0}
            c0 = ops.launch_counts()
            y = engine.infer(name, g["xs"][0])
            torch.cuda.synchronize()
            c1 = ops.launch_counts()
            ys = engine.serve_group([(name, x) for x in g["xs"]])
            torch.cuda.synchronize()
            c2 = ops.launch_counts()
            for kind, a, b in (("infer", c0, c1), ("serve_group", c1, c2)):
                got = {k: b[k] - a[k] for k in a}
                if got != want:
                    problems.append(f"{d} {name} {kind}: launches {got}, "
                                    f"want {want}")
            outs[name] = (y, ys, bands)
        counts = per_dispatch[d] = ops.launch_counts()
        for name, g in graphs.items():
            y, ys, bands = outs[name]
            pairs = [(y, g["y_infer"])] + list(zip(ys, g["y_group"]))
            bitwise = all(torch.equal(a, b) for a, b in pairs)
            err = max(max_err(a, b) for a, b in pairs)
            if not bitwise:
                problems.append(f"{d} {name}: logits not bitwise-equal to "
                                f"the ragged dispatch (max_abs_err {err})")
            again = [engine.infer(name, g["xs"][0])] + engine.serve_group(
                [(name, x) for x in g["xs"]])
            if not all(torch.equal(a, b) for a, b in zip(again, [y] + ys)):
                problems.append(f"{d} {name}: repeat not bitwise-equal")
            x_dev = torch.from_numpy(g["xs"][0]).cuda()
            prof = profile_calls(torch, lambda: engine.infer(name, x_dev))
            problems += profile_problems(f"{d} {name}", prof, g["profile"],
                                         bands)
            rows.append(dict(
                dispatch=d, graph=name, bands=bands,
                register_s=register_s[name],
                bitwise_vs_ragged=bitwise, max_abs_err_vs_ragged=err,
                infer_ms=wall_ms(torch, lambda: engine.infer(name,
                                                             g["xs"][0])),
                infer_dev_ms=wall_ms(torch, lambda: engine.infer(name,
                                                                 x_dev)),
                ragged_infer_ms=g["infer_ms"],
                ragged_infer_dev_ms=g["infer_dev_ms"],
                profile={k: prof[k] for k in ("kernels_per_infer",
                                              "device_ms_per_infer",
                                              "busy_share",
                                              "launches_per_infer")},
                ragged_profile={k: g["profile"][k] for k in (
                    "kernels_per_infer", "device_ms_per_infer")}))
        if counts["ell_spmm"] == 0 or counts["ragged_ell_spmm"] != 0:
            problems.append(f"{d}: launches {counts}")
    return problems, rows, per_dispatch


def profile_problems(what, prof, ragged, bands) -> list:
    """A per-K dispatch's profile of one infer against the ragged
    dispatch's: its ELL part is the band kernels alone, at most one per
    band per layer. A profile may miss or add a stray event, so the
    other kernels by name may exceed "ragged"'s by less than one per
    infer: the chain the band kernels replace launched a gather and a
    ``segment_reduce`` per layer."""
    got, base = prof["launches_per_infer"], ragged["launches_per_infer"]
    problems = []
    if got["ell_rows_kernel"] or not 0 < got["ell_band_kernel"] <= (
            LAYERS * bands):
        problems.append(f"{what}: ELL kernels per infer {got}, want only "
                        f"ell_band_kernel, {LAYERS * bands} per infer")
    extra = {k: got[k] - base[k] for k in got
             if k not in ("ell_rows_kernel", "ell_band_kernel")
             and got[k] - base[k] >= 1}
    if extra:
        problems.append(f"{what}: kernels per infer beyond the ragged "
                        f"dispatch's: {extra} (got {got}, ragged {base})")
    return problems


# ----------------------------------------------------------- lifecycle ----
def lifecycle_inputs(torch) -> dict:
    """The lifecycle phase's graphs, weights, features and spmm inputs."""
    from repro_torch.data.graphs import PAPER_DATASETS, make_paper_dataset

    rng = np.random.default_rng(SEED + 1)
    st = PAPER_DATASETS["pubmed"]
    ws = [glorot(rng, st.n_features, HIDDEN),
          glorot(rng, HIDDEN, st.n_classes)]
    graphs = {}
    for s in LIFECYCLE_SCALES:
        csr, x, _, _ = make_paper_dataset("pubmed", scale=s, seed=SEED)
        b = torch.from_numpy(rng.standard_normal(
            (csr.shape[0], HIDDEN)).astype(np.float32)).cuda()
        graphs[f"pubmed@{s}"] = (csr, x, b)
    return dict(ws=ws, graphs=graphs)


def lifecycle_phase(torch, inputs, dispatch) -> tuple:
    """Retire a shape class of three pubmed-shaped graphs on the card,
    on an ``Engine(ell_dispatch=dispatch)``.

    Returns (problems, record, launch counts of the phase).
    """
    from repro_torch.engine import Engine, LifecycleConfig, LifecycleManager
    from repro_torch.kernels import ops

    engine = Engine(device="cuda", ell_dispatch=dispatch)
    xs, bs = {}, {}
    for name, (csr, x, b) in inputs["graphs"].items():
        engine.register(name, csr, weights=inputs["ws"])
        xs[name], bs[name] = x, b
    classes = {engine.handle(n).sclass for n in xs}
    if len(classes) != 1:
        return [f"lifecycle {dispatch}: scales {LIFECYCLE_SCALES} fall "
                f"in {len(classes)} shape classes, not one"], {}, {}
    (sc,) = classes
    problems = []
    ops.reset_launch_counts()
    pre_spmm = {n: engine.spmm(n, b) for n, b in bs.items()}
    pre_infer = {n: engine.infer(n, x) for n, x in xs.items()}
    torch.cuda.synchronize()
    mgr = LifecycleManager(engine, config=LifecycleConfig(
        waste_budget=0.0, breach_windows=1, min_traffic=1))
    t0 = time.perf_counter()
    window = mgr.step()
    torch.cuda.synchronize()
    retire_s = time.perf_counter() - t0
    post_spmm = {n: engine.spmm(n, b) for n, b in bs.items()}
    post_infer = {n: engine.infer(n, x) for n, x in xs.items()}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if len(window["retired"]) != 1:
        problems.append(f"lifecycle {dispatch}: window retired {window['retired']}, "
                        f"skipped {window['skipped']}")
    if mgr.executors_invalidated < 1:
        problems.append(f"lifecycle {dispatch}: no executor invalidated")
    members = []
    for n in xs:
        succ = engine.handle(n).sclass
        spmm_bitwise = torch.equal(post_spmm[n], pre_spmm[n])
        infer_err = max_err(post_infer[n], pre_infer[n])
        members.append(dict(
            graph=n, rows=int(pre_infer[n].shape[0]),
            successor=succ.summary(),
            ell_mac_capacity=[sc.ell_mac_capacity, succ.ell_mac_capacity],
            n_padded_rows=[sc.n_row_tiles * sc.tile,
                           succ.n_row_tiles * succ.tile],
            spmm_bitwise=spmm_bitwise,
            spmm_max_abs_err=max_err(post_spmm[n], pre_spmm[n]),
            infer_bitwise=torch.equal(post_infer[n], pre_infer[n]),
            infer_max_abs_err=infer_err))
        if succ == sc or succ.ell_mac_capacity >= sc.ell_mac_capacity:
            problems.append(f"lifecycle {dispatch} {n}: successor "
                            f"{succ.summary()} is not tighter than "
                            f"{sc.summary()}")
        if not spmm_bitwise:
            problems.append(f"lifecycle {dispatch} {n}: spmm changed "
                            "across the retirement")
        if not close(post_infer[n], pre_infer[n], **LOGIT_TOL):
            problems.append(f"lifecycle {dispatch} {n}: infer max_abs_err "
                            f"{infer_err}")
    if not any(m["n_padded_rows"][1] < m["n_padded_rows"][0]
               for m in members):
        problems.append(f"lifecycle {dispatch}: no successor has fewer "
                        "padded rows than the retired class")
    # a replica view serves the successor class as the engine does
    keys = {}
    for n, x in xs.items():
        keys.setdefault(engine.group_key(n, x), []).append(n)
    group_names = max(keys.values(), key=len)
    group = [(n, xs[n]) for n in group_names] * 2
    want = engine.serve_group(group)
    got = engine.replica_view(0).serve_group(group)
    view_bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    if not view_bitwise:
        problems.append(f"lifecycle {dispatch}: replica view serve_group "
                        "differs from the engine's")
    ell_kernel = "ragged_ell_spmm" if dispatch == "ragged" else "ell_spmm"
    other = "ell_spmm" if dispatch == "ragged" else "ragged_ell_spmm"
    if counts["bsr_spmm"] == 0 or counts[ell_kernel] == 0 or counts[other]:
        problems.append(f"lifecycle {dispatch}: launches {counts}")
    record = dict(dispatch=dispatch, retired=window["retired"],
                  retire_s=retire_s,
                  executors_invalidated=mgr.executors_invalidated,
                  replica_group=len(group), replica_bitwise=view_bitwise,
                  launches=counts, members=members)
    return problems, record, counts


# --------------------------------------------------------- matmul path ----
def matmul_path(torch, engine, graphs) -> tuple:
    """The main path's X·W products of both layers through
    ``kernels.ops.matmul``, counters set to 0 before and read after.

    Returns (problems, [(graph, layer, A, B)], launch counts).
    """
    from repro_torch.kernels import ops

    problems, cases = [], []
    ops.reset_launch_counts()
    for name, g in graphs.items():
        h = engine.handle(name)
        a1 = engine.prepare_x(name, g["xs"][0])
        c1 = ops.matmul(a1, h.weights[0])
        a2 = torch.relu(c1)
        c2 = ops.matmul(a2, h.weights[1])
        torch.cuda.synchronize()
        for layer, a, w, c in ((1, a1, h.weights[0], c1),
                               (2, a2, h.weights[1], c2)):
            want = torch.matmul(a, w)
            if tuple(c.shape) != tuple(want.shape) or not matmul_close(
                    torch, c, want, a, w):
                problems.append(f"ops.matmul {name} layer {layer}: "
                                f"max_abs_err {max_err(c, want)}")
            cases.append((name, layer, a, w))
    counts = ops.launch_counts()
    if counts["tile_matmul"] != LAYERS * len(graphs):
        problems.append(f"matmul path: launches {counts}")
    return problems, cases, counts


# --------------------------------------------------------- kernel phase ----
def kernel_cases(torch, engine, graphs):
    """(graph, F, G, inputs, class meta) at the shapes the main path gave
    the sparse kernels: each graph's class-padded partition against B of
    width 128 (layer 1) and n_classes (layer 2), alone and stacked G=4."""
    from repro_torch.core.formats import b_tiles_of, plan_to, stack_plans

    for name, g in graphs.items():
        h = engine.handle(name)
        meta = h.sclass.to_meta()
        b1 = torch.matmul(engine.prepare_x(name, g["xs"][0]), h.weights[0])
        # layer 2's B is relu(A·B1)·W2; relu(B1)·W2 has its shape and scale
        b2 = torch.matmul(torch.relu(b1), h.weights[1])
        for b in (b1, b2):
            for G in (1, GROUP):
                bt = b_tiles_of(b[None].expand(G, -1, -1),
                                meta).contiguous()
                part = [torch.stack([leaf] * G).contiguous()
                        for leaf in (h.part.dense.tiles,
                                     h.part.dense.tile_col, h.part.ell.cols,
                                     h.part.ell.vals, h.part.ell.tile_col,
                                     h.part.ell.unit_k, h.part.ell.rows)]
                plan = plan_to(stack_plans([h.host_plan] * G), bt.device)
                yield dict(graph=name, F=int(b.shape[1]), G=G), (
                    part, bt, meta, plan.dense, plan.ell, plan.ell_bands)


def bsr_case(torch, case):
    """The dense engine as the main path runs it: one ``bsr_spmm_rows``
    launch, the products summed per row tile in the plan's order.

    Gates: within ``KERNEL_TOL`` of its plain version (``bsr_spmm_ref``
    then ``segment_sum``) relative to the sum of |tile|·|B| (the two add
    each 64-term dot product in another order); bit for bit equal to the
    per-tile kernel's products summed by ``segment_sum`` (the order the
    kernel keeps); the per-tile ``bsr_spmm`` within ``KERNEL_TOL`` of
    ``bsr_spmm_ref``. Library yardstick: ``torch.bmm`` on the gathered B
    tiles followed by ``segment_sum``, captured as one CUDA graph
    (``torch.bmm`` alone beside it)."""
    from repro_torch.core.formats import segment_sum
    from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_rows
    from repro_torch.kernels.ref import (_gather_b_tiles, bsr_spmm_ref,
                                         bsr_spmm_rows_ref)

    part, bt, _, plan = case[:4]
    tiles, tcol, dev = part[0], part[1], bt.device
    g, n_t, t, _ = tiles.shape
    f = bt.shape[-1]
    got = bsr_spmm_rows(tiles, tcol, bt, plan, device=dev)
    want = bsr_spmm_rows_ref(tiles, tcol, bt, plan)
    scale = bsr_spmm_rows_ref(tiles.abs(), tcol, bt.abs(), plan)
    per_tile = bsr_spmm(tiles, tcol, bt, device=dev)
    folded_bitwise = torch.equal(got, segment_sum(
        per_tile.reshape(g * n_t, t * f), plan).reshape(got.shape))
    per_tile_ok = close(per_tile, bsr_spmm_ref(tiles, tcol, bt), **KERNEL_TOL)
    ok = bool(((got - want).abs() <= KERNEL_TOL["atol"]
               + KERNEL_TOL["rtol"] * scale).all().item())
    gathered = _gather_b_tiles(bt, tcol)
    a3, b3 = tiles.reshape(g * n_t, t, t), gathered.reshape(g * n_t, t, f)

    def folded():
        return bsr_spmm_rows(tiles, tcol, bt, plan, device=dev)

    def library():
        return segment_sum(torch.bmm(a3, b3).reshape(g * n_t, t * f), plan)

    # bytes the folded function must move: the tiles the plan sums, the
    # B tiles they use, the row bands written, and the plan's indices
    order = plan.order.cpu().numpy()
    used = order.shape[0]
    used_b = len(np.unique((order // n_t) * (1 << 32)
                           + tcol.reshape(-1).cpu().numpy()[order]))
    n_rt = plan.lengths.shape[0] // g
    nbytes = (used * (t * t * 4 + 4 + 8) + used_b * t * f * 4
              + g * n_rt * t * f * 4 + (g * n_rt + 1) * 8)
    flops = 2.0 * used * t * t * f
    return dict(
        ok=ok and folded_bitwise and per_tile_ok, err=max_err(got, want),
        folded_bitwise=folded_bitwise, per_tile_ok=per_tile_ok,
        tiles_summed=used, row_tiles=n_rt,
        ms=device_ms(torch, folded), call_ms=call_ms(torch, folded),
        per_tile_ms=device_ms(torch, lambda: bsr_spmm(tiles, tcol, bt,
                                                      device=dev)),
        plain_ms=device_ms(torch, lambda: bsr_spmm_rows_ref(tiles, tcol, bt,
                                                            plan)),
        library_ms=device_ms(torch, library),
        library_bmm_ms=device_ms(torch, lambda: torch.bmm(a3, b3)),
        bound=bound(nbytes, flops))


def ell_bytes(cols, tcol, live, t, f, g, u, r, plan=None) -> float:
    """Bytes an ELL function must move.

    Per unit (``plan`` None): its cols/vals lanes, tile_col, each distinct
    B row its lanes ``live`` address, and the [G, U, R, F] output.

    Folded onto rows (``plan``, the ELL ``SegmentPlan``): cols/vals of the
    unit rows the plan sums, every Kmax lane of each (the mask sits on the
    values, so a masked lane's B row is read too, and ``live`` is not
    used), tile_col and unit_k of their units, the plan's order, the
    offsets and live-table entries of its live rows, each distinct B row
    those lanes address, and the live output rows, read once and written
    once (no per-unit output).
    """
    c = cols.cpu().numpy()
    tc = tcol.cpu().numpy()
    if plan is None:
        live = np.broadcast_to(live, cols.shape)
        gid = np.broadcast_to(np.arange(g)[:, None, None, None], cols.shape)
        rows = tc[:, :, None, None] * t + c
        used_rows = len(np.unique(gid[live] * (1 << 40) + rows[live]))
        return (cols.numel() * 8 + tcol.numel() * 4 + used_rows * f * 4
                + g * u * r * f * 4)
    kmax = c.shape[-1]
    order = plan.order.cpu().numpy()
    segs = np.flatnonzero(plan.lengths.cpu().numpy())
    unit = order // r                                 # over the group
    b_rows = ((unit // u)[:, None] * (1 << 40)
              + tc.reshape(-1)[unit][:, None] * t
              + c.reshape(-1, kmax)[order])
    used_rows = len(np.unique(b_rows))
    used_offsets = len(np.unique(np.concatenate([segs, segs + 1])))
    return (order.size * kmax * 8 + len(np.unique(unit)) * 8
            + order.size * 8 + used_offsets * 8 + segs.size * 8
            + used_rows * f * 4 + 2 * segs.size * f * 4)


def rows_csr(torch, cols, vals, tcol, uk, rows, meta, nct, t):
    """The ELL entries as CSRs with int32 indices against B tiles
    [G·nct·T, F] (sentinel rows and masked lanes dropped, duplicates
    summed; built on the host, outside any timed region): one over all
    G·P padded rows, one over only the rows with an entry, and those
    rows' ids."""
    g, u, r, k = cols.shape
    p = meta.n_padded_rows
    c = cols.cpu().numpy().astype(np.int64)
    v = vals.cpu().numpy()
    rw = np.broadcast_to(rows.cpu().numpy()[..., None], c.shape)
    keep = ((np.arange(k) < uk.cpu().numpy()[:, :, None, None])
            & (rw != meta.ell_sentinel_row) & (v != 0))
    gi, ui, _, _ = np.nonzero(keep)
    tc = tcol.cpu().numpy().astype(np.int64)
    row = gi * p + rw[keep]
    col = (gi * nct + tc[gi, ui]) * t + c[keep]
    live, pos = np.unique(row, return_inverse=True)

    def csr(at, n_rows):
        m = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([at, col])), torch.from_numpy(v[keep]),
            (n_rows, g * nct * t), check_invariants=False).coalesce()
        m = m.to_sparse_csr()
        return torch.sparse_csr_tensor(
            m.crow_indices().int(), m.col_indices().int(), m.values(),
            m.shape).to(cols.device)

    return (csr(row, g * p), csr(pos, live.size),
            torch.from_numpy(live).to(cols.device))


def dense_rows(part, bt, dense_plan, p):
    """The dense engine's rows [G, P, F] as the main path makes them:
    one ``bsr_spmm_rows`` launch, or +0 rows and no launch for a class
    without dense tiles (``ops.dense_tiles_matmul``)."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_rows

    g, f = bt.shape[0], bt.shape[-1]
    if part[0].shape[1] == 0:
        return bt.new_zeros((g, p, f))
    return bsr_spmm_rows(part[0], part[1], bt, dense_plan,
                         device=bt.device).reshape(g, p, f)


def ell_case(torch, case):
    """The sparse engine as the main path runs it: one ``ragged_ell_rows``
    launch, the per-unit products summed onto the padded rows in plan
    order and added onto the dense engine's rows in place.

    Gates: bit for bit equal to its plain version (``ragged_ell_rows_ref``)
    and to the parent's chain (per-unit ``ragged_ell_spmm`` +
    ``scatter_ell_partials`` + ``yd + ye``); the per-unit kernel bit for
    bit equal to ``ragged_ell_spmm_ref``. Yardsticks: the parent's chain
    as one CUDA graph, the per-unit kernel alone, and ``torch.sparse.mm``
    over a CSR of the ELL entries: over only the rows with an entry, then
    ``index_add_`` onto those rows (``library_ms``), and over all padded
    rows, plus the add, with the two kernels that take it the most device
    time (cuSPARSE's SpMM time grows with the CSR's row count, even
    where almost every row is empty)."""
    from repro_torch.core.formats import scatter_ell_partials
    from repro_torch.kernels.ell_spmm import ragged_ell_rows, ragged_ell_spmm
    from repro_torch.kernels.ref import (ragged_ell_rows_ref,
                                         ragged_ell_spmm_ref)

    part, bt, meta, dense_plan, plan = case[:5]
    cols, vals, tcol, uk, rows = part[2:7]
    dev = bt.device
    g, u, r, kmax = cols.shape
    nct, t, f = bt.shape[1:]
    p = meta.n_padded_rows
    yd = dense_rows(part, bt, dense_plan, p)

    def per_unit():
        return ragged_ell_spmm(cols, vals, tcol, uk, bt, device=dev)

    def chain():
        ye = scatter_ell_partials(rows.reshape(g, u * r),
                                  per_unit().reshape(g, u * r, f), meta,
                                  plan=plan)
        return yd + ye

    got = ragged_ell_rows(cols, vals, tcol, uk, bt, plan, yd.clone(),
                          device=dev)
    want = ragged_ell_rows_ref(cols, vals, tcol, uk, bt, plan, yd.clone())
    folded_bitwise = torch.equal(got, chain())
    per_unit_ok = torch.equal(per_unit(), ragged_ell_spmm_ref(
        cols, vals, tcol, uk, bt))
    buf, plain_buf, lib_buf = yd.clone(), yd.clone(), yd.clone()
    all_csr, live_csr, live_ids = rows_csr(torch, cols, vals, tcol, uk, rows,
                                           meta, nct, t)
    b2 = bt.reshape(g * nct * t, f)

    def all_rows():
        return yd + torch.sparse.mm(all_csr, b2).reshape(g, p, f)

    lengths = plan.lengths.cpu().numpy()
    entries = plan.order.shape[0]
    live = np.broadcast_to(np.arange(kmax)[None, None, None, :]
                           < uk.cpu().numpy()[:, :, None, None], cols.shape)
    flops = 2.0 * entries * kmax * f + entries * f + (lengths > 0).sum() * f
    return dict(
        ok=bool(torch.equal(got, want)) and folded_bitwise and per_unit_ok,
        err=max_err(got, want), folded_bitwise=folded_bitwise,
        per_unit_ok=per_unit_ok, entries=entries,
        live_rows=int((lengths > 0).sum()),
        ms=device_ms(torch, lambda: ragged_ell_rows(
            cols, vals, tcol, uk, bt, plan, buf, device=dev)),
        call_ms=call_ms(torch, lambda: ragged_ell_rows(
            cols, vals, tcol, uk, bt, plan, buf, device=dev)),
        plain_ms=device_ms(torch, lambda: ragged_ell_rows_ref(
            cols, vals, tcol, uk, bt, plan, plain_buf)),
        library_ms=device_ms(torch, lambda: lib_buf.view(g * p, f).index_add_(
            0, live_ids, torch.sparse.mm(live_csr, b2))),
        library_all_rows_ms=device_ms(torch, all_rows),
        library_all_rows_top=profile_calls(torch, all_rows,
                                           calls=1)["top"][:2],
        parent_chain_ms=device_ms(torch, chain),
        per_unit_ms=device_ms(torch, per_unit),
        per_unit_bound_ms=bound(ell_bytes(cols, tcol, live, t, f, g, u, r)
                                + uk.numel() * 4,
                                2.0 * int(live.sum()) * f)[0],
        bound=bound(ell_bytes(cols, tcol, None, t, f, g, u, r, plan=plan),
                    flops))


def band_bytes(buckets, bands, t, f) -> tuple:
    """(bytes, operations) of one layer's band rows: cols/vals of the unit
    rows the band plans sum (the band's K lanes of each), their units'
    tile_col, the plans' order and their live slots' offsets, row and
    carry entries, each distinct B row those lanes address, the live
    output rows read and written once, and each carried row written and
    read once."""
    nbytes = flops = 0.0
    b_rows, out_rows = set(), set()
    for bk, band in zip(buckets, bands):
        g, u, r, k = bk.cols.shape
        order = band.order.cpu().numpy()
        rows = band.rows.cpu().numpy()
        carry = band.carry.cpu().numpy()
        gi, si = np.nonzero(rows >= 0)
        lengths = np.diff(band.offsets.cpu().numpy()).reshape(rows.shape)
        member = np.repeat(gi, lengths[gi, si])       # member of each entry
        unit = order // r
        c = bk.cols.cpu().numpy().reshape(g, u * r, k)[member, order]
        tc = bk.tile_col.cpu().numpy()[member, unit]
        b_rows.update(((member * (1 << 20) + tc)[:, None] * t + c)
                      .reshape(-1).tolist())
        out_rows.update((gi * (1 << 32) + rows[gi, si]).tolist())
        n_carried = int((carry[gi, si] >= 0).sum())
        nbytes += (order.size * k * 8 + len(set(zip(member, unit))) * 4
                   + order.size * 8 + (3 * gi.size + 1) * 8
                   + n_carried * f * 4)
        flops += 2.0 * order.size * k * f + order.size * f
    nbytes += len(b_rows) * f * 4 + len(out_rows) * f * 8
    flops += len(out_rows) * f
    return nbytes, flops


def fixed_ell_case(torch, case):
    """One layer's ELL rows as the "fused"/"loop" dispatches run them: one
    ``ell_spmm_rows`` launch per class band, each summing its unit rows'
    products onto the padded rows (carrying a row's sum from band to
    band) and adding them onto the dense engine's rows in place.

    Gates: bit for bit equal to its plain version (``ell_spmm_rows_ref``
    band after band) and to the parent's chains: the per-unit
    ``ell_spmm`` kernel per band, ``scatter_ell_partials`` at once
    ("fused", in the order of ``plan.ell``) or bucket by bucket into a
    running buffer ("loop"), then ``yd + ye``; one launch per band.
    Yardsticks: both chains as CUDA graphs, and ``torch.sparse.mm`` over a
    CSR of the ELL entries of only the rows with an entry, then
    ``index_add_`` onto those rows."""
    from repro_torch.core.formats import (RaggedEll, bucket_plan,
                                          ell_buckets, scatter_ell_partials)
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_spmm import ell_spmm, ell_spmm_rows
    from repro_torch.kernels.ref import ell_spmm_rows_ref

    part, bt, meta, dense_plan, plan, bands = case
    cols, vals, tcol, uk, rows = part[2:7]
    dev = bt.device
    g, u, r, kmax = cols.shape
    nct, t, f = bt.shape[1:]
    p = meta.n_padded_rows
    buckets = ell_buckets(RaggedEll(cols, vals, rows, tcol, uk),
                          meta.ell_segments)
    n_carry = bands[0].n_carry
    carry = torch.zeros((g, n_carry, f), device=dev)
    yd = dense_rows(part, bt, dense_plan, p)

    def folded(out, rows_fn=ell_spmm_rows, **kw):
        for bk, band in zip(buckets, bands):
            rows_fn(bk.cols, bk.vals, bk.tile_col, bt, band, out, carry, **kw)
        return out

    prod = torch.empty((g, u, r, f), dtype=torch.float32, device=dev)

    def products():
        at = 0
        for bk in buckets:
            n = bk.cols.shape[-3]
            ell_spmm(bk.cols, bk.vals, bk.tile_col, bt,
                     out=prod[:, at:at + n], device=dev)
            at += n
        return prod

    loop_plans = [bucket_plan(bk.rows.reshape(g, -1), meta, dev)
                  for bk in buckets]

    def fused_chain():
        return yd + scatter_ell_partials(rows.reshape(g, u * r),
                                         products().reshape(g, u * r, f),
                                         meta, plan=plan)

    def loop_chain():
        pr, at, parts = products(), 0, []
        for bk in buckets:
            n = bk.cols.shape[-3]
            parts.append(pr[:, at:at + n].reshape(g, n * r, f))
            at += n
        return yd + scatter_ell_partials(
            [bk.rows.reshape(g, -1) for bk in buckets], parts, meta,
            plan=loop_plans)

    c0 = ops.launch_counts()["ell_spmm"]
    got = folded(yd.clone(), device=dev)
    launches_per_call = ops.launch_counts()["ell_spmm"] - c0
    want = folded(yd.clone(), ell_spmm_rows_ref)
    fused_bitwise = torch.equal(got, fused_chain())
    loop_bitwise = torch.equal(got, loop_chain())
    _, live_csr, live_ids = rows_csr(torch, cols, vals, tcol, uk, rows,
                                     meta, nct, t)
    b2 = bt.reshape(g * nct * t, f)
    buf, plain_buf, lib_buf = yd.clone(), yd.clone(), yd.clone()
    nbytes, flops = band_bytes(buckets, bands, t, f)
    return dict(
        ok=(bool(torch.equal(got, want)) and fused_bitwise and loop_bitwise
            and launches_per_call == len(buckets)),
        err=max_err(got, want), folded_bitwise=fused_bitwise,
        loop_bitwise=loop_bitwise, launches_per_call=launches_per_call,
        bands=[[int(bk.cols.shape[-1]), int(band.rows.shape[1])]
               for bk, band in zip(buckets, bands)],
        ms=device_ms(torch, lambda: folded(buf, device=dev)),
        call_ms=call_ms(torch, lambda: folded(buf, device=dev)),
        # the plain version syncs (its loops and masks are sized from the
        # plan's data), so it is timed per call, not as a CUDA graph
        plain_ms=call_ms(torch, lambda: folded(plain_buf,
                                               ell_spmm_rows_ref)),
        library_ms=device_ms(torch, lambda: lib_buf.view(g * p, f).index_add_(
            0, live_ids, torch.sparse.mm(live_csr, b2))),
        parent_chain_ms=device_ms(torch, fused_chain),
        parent_loop_chain_ms=device_ms(torch, loop_chain),
        per_unit_ms=device_ms(torch, products),
        # device kernels of one call, from a profile
        kernels_per_call=profile_calls(torch, lambda: folded(
            buf, device=dev), calls=1)["kernels_per_infer"],
        parent_chain_kernels=profile_calls(
            torch, fused_chain, calls=1)["kernels_per_infer"],
        parent_loop_chain_kernels=profile_calls(
            torch, loop_chain, calls=1)["kernels_per_infer"],
        bound=bound(nbytes, flops))


def matmul_case(torch, case):
    """``tile_matmul`` at the configuration the wrapper picks, held against
    ``torch.matmul``; every configuration is timed and must give the
    picked one's bits."""
    from repro_torch.kernels.ref import tile_matmul_ref
    from repro_torch.kernels.tile_matmul import CONFIGS, tile_matmul

    a, b = case
    got = tile_matmul(a, b, device=a.device)
    want = tile_matmul_ref(a, b)
    m, k = a.shape
    n = b.shape[1]
    configs_bitwise = all(torch.equal(tile_matmul(a, b, config=c,
                                                      device=a.device), got)
                          for c in CONFIGS)
    config_ms = {c: device_ms(torch, lambda c=c: tile_matmul(
                     a, b, config=c, device=a.device))
                 for c in CONFIGS}
    return dict(
        ok=matmul_close(torch, got, want, a, b) and configs_bitwise,
        err=max_err(got, want), configs_bitwise=configs_bitwise,
        config_ms=config_ms,
        ms=device_ms(torch, lambda: tile_matmul(a, b, device=a.device)),
        call_ms=call_ms(torch, lambda: tile_matmul(a, b, device=a.device)),
        plain_ms=device_ms(torch, lambda: tile_matmul_ref(a, b)),
        library_ms=device_ms(torch, lambda: torch.matmul(a, b)),
        bound=bound(4.0 * (m * k + k * n + m * n), 2.0 * m * k * n))


KERNELS = (
    ("ragged_ell_spmm", "src/repro_torch/kernels/csrc/ragged_ell_spmm.cu",
     "src/repro/kernels/ell_spmm.py:433", ell_case, "ell"),
    ("bsr_spmm", "src/repro_torch/kernels/csrc/bsr_spmm.cu",
     "src/repro/kernels/bsr_spmm.py:28", bsr_case, "sparse"),
    ("ell_spmm", "src/repro_torch/kernels/csrc/ell_spmm.cu",
     "src/repro/kernels/ell_spmm.py:322", fixed_ell_case, "ell"),
    ("tile_matmul", "src/repro_torch/kernels/csrc/tile_matmul.cu",
     "src/repro/kernels/tile_matmul.py:66", matmul_case, "matmul"),
)


def kernel_phase(torch, engine, graphs, launches, matmul_cases,
                 build_log, reordered: str) -> tuple:
    """Hold each kernel against its plain version at every shape its path
    gave it, and time it. ``launches`` maps each kernel to the count of
    its path's run, or to {path: count} for a kernel of several paths
    (``launches`` is then the first path's count); ``build_log`` is the
    build's log, whose ptxas lines each entry carries. The ELL kernels
    also run at the shapes of the ``reordered`` graph (cora reordered by
    labels, whose class puts every tile into the ELL engine)."""
    problems, entries = [], []
    ell = list(kernel_cases(torch, engine, dict(
        graphs, **{reordered: graphs["cora"]})))
    cases = {"sparse": [c for c in ell if c[0]["graph"] != reordered],
             "ell": ell,
             "matmul": [(dict(graph=name, layer=layer,
                              shape=[int(a.shape[0]), int(a.shape[1]),
                                     int(w.shape[1])]), (a, w))
                        for name, layer, a, w in matmul_cases]}
    for kname, source, replaces, run, kind in KERNELS:
        rows = []
        for label, case in cases[kind]:
            res = run(torch, case)
            row = dict(label, ms=res["ms"], call_ms=res["call_ms"],
                       plain_ms=res["plain_ms"], library_ms=res["library_ms"],
                       bound_ms=res["bound"][0], bound_by=res["bound"][1],
                       max_abs_err=res["err"])
            for extra in ("launches_per_call", "folded_bitwise",
                          "loop_bitwise", "bands", "parent_loop_chain_ms",
                          "kernels_per_call", "parent_chain_kernels",
                          "parent_loop_chain_kernels",
                          "per_tile_ok", "tiles_summed", "row_tiles",
                          "per_tile_ms", "library_bmm_ms",
                          "configs_bitwise", "config_ms", "per_unit_ok",
                          "entries", "live_rows", "parent_chain_ms",
                          "per_unit_ms", "per_unit_bound_ms",
                          "library_all_rows_ms", "library_all_rows_top"):
                if extra in res:
                    row[extra] = res[extra]
            rows.append(row)
            print(f"  {kname:16s} {json.dumps(label):52s} kernel "
                  f"{res['ms']:.4f} ms (call {res['call_ms']:.4f})  plain "
                  f"{res['plain_ms']:.4f} ms  library "
                  f"{res['library_ms']:.4f} ms  bound "
                  f"{res['bound'][0]:.5f} ms "
                  f"({res['bound'][1]})  max_abs_err {res['err']:.3g}")
            if "config_ms" in res:
                print("    configs " + json.dumps(res["config_ms"])
                      + f" bitwise {res['configs_bitwise']}")
            if "library_bmm_ms" in res:
                print(f"    per-tile kernel {res['per_tile_ms']:.4f} ms  "
                      f"torch.bmm alone {res['library_bmm_ms']:.4f} ms  "
                      f"folded bitwise {res['folded_bitwise']}  tiles "
                      f"{res['tiles_summed']} over {res['row_tiles']} "
                      "row tiles")
            if "parent_loop_chain_ms" in res:
                print(f"    parent chains: fused {res['parent_chain_ms']:.4f} "
                      f"ms, loop {res['parent_loop_chain_ms']:.4f} ms "
                      f"(per-unit kernels alone {res['per_unit_ms']:.4f}); "
                      f"kernels per call {res['kernels_per_call']} (chains "
                      f"{res['parent_chain_kernels']}, "
                      f"{res['parent_loop_chain_kernels']})  "
                      f"bitwise fused {res['folded_bitwise']} loop "
                      f"{res['loop_bitwise']}  [K, live rows] per band "
                      f"{res['bands']}")
            elif "parent_chain_ms" in res:
                print(f"    parent chain {res['parent_chain_ms']:.4f} ms  "
                      f"sparse.mm over all rows + add "
                      f"{res['library_all_rows_ms']:.4f} ms "
                      f"{json.dumps(res['library_all_rows_top'])}  "
                      f"per-unit kernel {res['per_unit_ms']:.4f} ms (bound "
                      f"{res['per_unit_bound_ms']:.5f})  folded bitwise "
                      f"{res['folded_bitwise']}  {res['entries']} unit rows "
                      f"onto {res['live_rows']} live rows")
            if not res["ok"]:
                why = {k: res[k] for k in ("folded_bitwise", "loop_bitwise",
                                           "per_unit_ok", "per_tile_ok",
                                           "configs_bitwise",
                                           "launches_per_call") if k in res}
                problems.append(f"{kname} {label}: disagrees with its plain "
                                f"version ({res['err']}; {why})")
        head = rows[0]   # cora: layer 1 of the first dispatch, G=1
        n = launches[kname]
        by_path = dict(launches_by_path=n) if isinstance(n, dict) else {}
        entries.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=next(iter(n.values())) if by_path else n, **by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            shape=", ".join(f"{k}={v}" for k, v in head.items()
                            if k in ("graph", "F", "G", "layer", "shape")),
            ptxas=ptxas_summary(build_log[os.path.basename(source)[:-3]]
                                ["log"]),
            cases=rows))
    return problems, entries


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke needs a GPU")
    src = os.path.join(HERE, "src")
    sys.path.insert(0, src)
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"cannot import the port from {src}: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t_start = t0 = time.perf_counter()
    log = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(log)} sources")
    for name, entry in sorted(log.items()):
        print(f"  {name}: {'cached' if entry['cached'] else 'built'}")
        for line in ptxas_summary(entry["log"]):
            print(f"    {line}")

    engine, graphs, counts = main_path(torch)
    print(f"main path launches: {counts}")
    problems = check_main_path(torch, engine, graphs, counts)
    for name, g in graphs.items():
        x_dev = torch.from_numpy(g["xs"][0]).cuda()
        g["profile"] = profile_calls(torch, lambda: engine.infer(name,
                                                                 x_dev))

    s_problems, serving = serving_phase(torch, engine, graphs, smi)
    problems += s_problems
    for mode in ("serial", "pipelined", "replicas", "chaos_poison",
                 "chaos_hang"):
        r = serving[mode]
        print(f"serving {mode}: {r['completed']} completed in "
              f"{r['batches']} batches, p50 {r['p50_ms']:.3f} ms, p99 "
              f"{r['p99_ms']:.3f} ms, wall {r['wall_s']:.3f} s, overlap "
              f"{r['overlap_ratio']:.3f}, inflight peak "
              f"{r['inflight_peak']}")

    r_problems, reordered, r_counts = reordered_phase(torch, engine, graphs)
    problems += r_problems
    print(f"reordered graph launches: {r_counts}")
    print("  " + json.dumps(reordered))

    ab_problems, ab_rows, ab_counts = dispatch_ab(torch, graphs)
    problems += ab_problems
    for d, c in ab_counts.items():
        print(f"dispatch A/B launches, {d}: {c}")
    for row in ab_rows:
        print("  " + json.dumps(row))

    lc_inputs = lifecycle_inputs(torch)
    lifecycle = []
    for d in LIFECYCLE_DISPATCHES:
        lc_problems, record, _ = lifecycle_phase(torch, lc_inputs, d)
        problems += lc_problems
        lifecycle.append(record)
        print(f"lifecycle {d}: " + json.dumps(record))

    mm_problems, mm_cases, mm_counts = matmul_path(torch, engine, graphs)
    problems += mm_problems
    print(f"matmul path launches: {mm_counts}")

    e2e = []
    for name, g in graphs.items():
        h = engine.handle(name)
        prof = g["profile"]
        row = dict(graph=name, n=g["n"], register_s=g["register_s"],
                   infer_ms=g["infer_ms"], infer_dev_ms=g["infer_dev_ms"],
                   group4_ms=g["group_ms"],
                   err_vs_torch=g["err_vs_torch"],
                   err_group_vs_infer=g["err_group_vs_infer"],
                   group_bitwise_infer=g["group_bitwise_infer"],
                   shape_class=h.sclass.summary(), profile=prof)
        e2e.append(row)
        print(f"  {name}: " + json.dumps(row))
    print(f"kernels (device ms per call: CUDA graphs of {GRAPH_CALLS} calls, "
          f"median of {TIMING_REPS} replays; call = one call from Python; "
          "bound at 3.35 TB/s, 67 TFLOP/s f32):")
    launches = {"ragged_ell_spmm": counts["ragged_ell_spmm"],
                "bsr_spmm": counts["bsr_spmm"],
                "ell_spmm": {d: c["ell_spmm"] for d, c in ab_counts.items()},
                "tile_matmul": mm_counts["tile_matmul"]}
    kproblems, entries = kernel_phase(torch, engine, graphs, launches,
                                      mm_cases, log, reordered["graph"])
    problems += kproblems
    print(json.dumps({"e2e": e2e, "reordered": reordered,
                      "dispatch_ab": ab_rows, "lifecycle": lifecycle}))
    print(f"smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"serving": serving}))
    print(json.dumps({"kernels": entries}))
    if problems:
        for p in problems:
            print(f"chip_smoke: FAIL: {p}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
