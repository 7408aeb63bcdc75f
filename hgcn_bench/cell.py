"""One run of one cell: set-up, the measured window, the check.

``Session`` builds what a configuration serves: the graph (from the
frozen generator), the weights and the feature pool (on the device,
from the seed), and ``repro_torch``'s ``Engine`` with the graph
registered; the configuration's model module (``spec.model_of``) makes
the inputs, registers the graph and gives the reference. ``closed_loop``
and ``open_loop`` drive a started ``RequestQueue`` with a mix of
``traffic``. ``run_cell`` puts these together as a run of the benchmark
does and returns its result line.
"""
from __future__ import annotations

import gc
import math
import queue as queue_mod
import sys
import threading
import time

import numpy as np

from hgcn_bench import graphgen, traffic as traffic_mod, yardstick
from hgcn_bench.reference import logit_err
from hgcn_bench.spec import model_of

CLOCK = time.monotonic
# how long past the window's close a request still counts as late, not
# lost (the contract's minute)
LATE_S = 60.0
# the short profiled window a traced run takes after the measured one
PROFILE_S = 1.5
# a reading not taken yet
_UNSET = object()


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def make_inputs(torch, config: dict, traffic: dict, seed: int, n: int,
                device) -> tuple:
    """The weights and the feature pool of the configuration's model,
    made on the device from the seed (its module's ``make_inputs``)."""
    return model_of(config).make_inputs(torch, config, traffic, seed, n,
                                        device)


class Session:
    """The served graph and its inputs, ready to take traffic.

    ``config`` is a configuration file's contents; ``device`` "cuda"
    on the card ("cpu" drives the same code through the kernels' plain
    versions, for the tests)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 cache_dir=graphgen.CACHE_DIR):
        import torch

        from repro_torch.core.formats import csr_from_scipy
        from repro_torch.engine import Engine

        self.torch = torch
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        graph = config["graph"]
        self.model = model_of(config)
        self.name = config["name"]
        t0 = time.perf_counter()
        self.atil, self.labels, cached = graphgen.load_graph(
            self.name, graph, cache_dir)
        self.graph_s = time.perf_counter() - t0
        self.graph_cached = cached
        self.n = self.atil.shape[0]
        self.nnz = int(self.atil.nnz)
        want = config.get("expected", {}).get("nnz_a_tilde")
        if want is not None and want != self.nnz:
            raise ValueError(f"{self.name}: A_tilde has {self.nnz} nonzeros, "
                             f"the configuration states {want}")
        self.weights, self.pool = self.make_inputs()
        self.engine = Engine(device=self.device)
        t0 = time.perf_counter()
        self.handle = self.model.register(
            self.engine, self.name, csr_from_scipy(self.atil), graph,
            self.labels, self.weights)
        self._sync()
        self.register_s = time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def make_inputs(self) -> tuple:
        return self.model.make_inputs(self.torch, self.config, self.traffic,
                                      self.seed, self.n, self.device)

    def warm(self) -> None:
        """Build every executor and kernel the mix's batches use: one
        dispatch at each power-of-two group size up to the batch
        target."""
        b = 1
        while b <= int(self.traffic["target_batch"]):
            self.engine.serve_group([(self.name, self.pool[0])] * b)
            b *= 2
        self._sync()

    def queue(self, tracer=None):
        """A started pipelined ``RequestQueue`` with the mix's
        settings."""
        from repro_torch.serving import RequestQueue

        t = self.traffic
        return RequestQueue(
            self.engine, pipelined=True, max_inflight=int(t["max_inflight"]),
            target_batch=int(t["target_batch"]),
            default_deadline_ms=float(t["deadline_ms"]),
            tracer=tracer).start()

    def free(self) -> None:
        """Drop the program's state (engine, registered graph) and
        return its memory to the device."""
        self.engine = self.handle = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


class DispatchProbe:
    """Wraps one engine instance's ``prepare_x`` and
    ``serve_group_async`` to time each dispatch: host seconds from entry
    to return of the enqueue, and CUDA events on the stream where the
    dispatch's staging starts and where its work ends."""

    def __init__(self, engine, torch):
        self.torch = torch
        self.cuda = engine.device.type == "cuda"
        self._prepare = engine.prepare_x
        self._serve = engine.serve_group_async
        self._start = None
        self.rows: list = []       # (host t at entry, host s, ev0, ev1)
        engine.prepare_x = self.prepare_x
        engine.serve_group_async = self.serve_group_async

    def event(self):
        if not self.cuda:
            return None
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def prepare_x(self, name, x):
        if self._start is None:
            self._start = self.event()
        return self._prepare(name, x)

    def serve_group_async(self, requests, prepared=None, **kw):
        ev0 = self._start if self._start is not None else self.event()
        self._start = None
        t0 = CLOCK()
        out = self._serve(requests, prepared, **kw)
        host_s = CLOCK() - t0
        self.rows.append((t0, host_s, ev0, self.event()))
        return out


class Window:
    """What one measured window of a loop saw."""

    def __init__(self, kind: str):
        self.kind = kind
        self.t_start = self.t_end = None
        self.records: list = []      # every request of the run
        self.ev_start = self.ev_end = None
        self.completed0 = self.batches0 = 0
        self.completed1 = self.batches1 = 0
        self.lateness: list = []

    def in_window(self, rec) -> bool:
        """A closed loop counts the requests that resolve inside the
        window; an open loop those that are due inside it."""
        t = rec["done"] if self.kind == "closed" else rec["due"]
        return (self.t_start is not None and t is not None
                and self.t_start <= t <= self.t_end)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    def counted(self) -> list:
        return [r for r in self.records if self.in_window(r)]


class _Driver:
    """Submits requests and records their resolution; keeps a seeded
    sample of the window's outputs for the comparison."""

    def __init__(self, sess: Session, q, seed: int, win: Window,
                 reservoir=None):
        self.sess, self.q, self.win = sess, q, win
        self.rng = traffic_mod.rng(seed, 1)
        self.deadline_ms = float(sess.traffic["deadline_ms"])
        self.reservoir = reservoir
        self.lock = threading.Lock()
        self.done_q: queue_mod.Queue = queue_mod.Queue()
        self.unresolved = 0

    def submit(self, due: float) -> dict:
        from repro_torch.serving import AdmissionError

        k = int(self.rng.integers(0, int(self.sess.traffic["snapshots"])))
        rec = {"snap": k, "due": due, "submit": CLOCK(), "done": None,
               "ok": None}
        self.win.records.append(rec)
        with self.lock:
            self.unresolved += 1
        try:
            fut = self.q.submit(self.sess.name, self.sess.pool[k],
                                deadline_ms=self.deadline_ms)
        except AdmissionError:
            self._resolve(rec, None)
            return rec
        fut.add_done_callback(lambda f, rec=rec: self._resolve(rec, f))
        return rec

    def _resolve(self, rec, fut) -> None:
        rec["done"] = CLOCK()
        y = None
        if fut is not None:
            try:
                y = fut.result()
                rec["ok"] = True
            except Exception:  # noqa: BLE001 -- a failed request is counted
                rec["ok"] = False
        else:
            rec["ok"] = False
        if rec["ok"] and self.reservoir is not None \
                and self.win.in_window(rec):
            with self.lock:
                self.reservoir.offer((rec["snap"], y))
        with self.lock:
            self.unresolved -= 1
        self.done_q.put(rec)

    def wait_all(self, until: float) -> None:
        while True:
            with self.lock:
                if self.unresolved == 0:
                    return
            if CLOCK() > until:
                return
            time.sleep(0.002)


def _mark(sess: Session, win: Window, which: str) -> None:
    """Record a CUDA event at the window's open or close (on the card)."""
    ev = None
    if sess.device.type == "cuda":
        ev = sess.torch.cuda.Event(enable_timing=True)
        ev.record()
    setattr(win, f"ev_{which}", ev)


def closed_loop(sess: Session, q, seed: int, seconds: float, *,
                warmup: int, reservoir=None, on_start=None) -> Window:
    """``outstanding`` requests in flight, each replaced when it
    resolves; the window opens after ``warmup`` resolutions and lasts
    ``seconds``."""
    win = Window("closed")
    drv = _Driver(sess, q, seed, win, reservoir)
    for _ in range(int(sess.traffic["outstanding"])):
        drv.submit(CLOCK())
    for _ in range(warmup):
        drv.done_q.get(timeout=LATE_S)
        drv.submit(CLOCK())
    if on_start is not None:
        on_start()
    win.completed0, win.batches0 = q.stats.completed, q.stats.batches
    _mark(sess, win, "start")
    t0 = CLOCK()
    win.t_end = t0 + seconds      # before t_start: callbacks test both
    win.t_start = t0
    while True:
        left = win.t_end - CLOCK()
        if left <= 0:
            break
        try:
            drv.done_q.get(timeout=left)
        except queue_mod.Empty:
            break
        if CLOCK() < win.t_end:
            drv.submit(CLOCK())
    _mark(sess, win, "end")
    win.completed1, win.batches1 = q.stats.completed, q.stats.batches
    drv.wait_all(win.t_end + LATE_S)
    return win


def open_loop(sess: Session, q, seed: int, seconds: float, *,
              warmup_s: float, reservoir=None, on_start=None) -> Window:
    """Poisson arrivals at the mix's rate, each submitted at its due
    time; ``warmup_s`` of them, then the window's ``seconds``. Each
    request is timed from its due time, so a late submit counts against
    the system, and the submit's lateness is kept."""
    win = Window("open")
    drv = _Driver(sess, q, seed, win, reservoir)
    t = sess.traffic
    warm = traffic_mod.arrivals(t, seed, warmup_s) if warmup_s > 0 \
        else np.zeros(0)
    offs = traffic_mod.arrivals(t, seed, seconds)
    base = CLOCK() + 0.01
    # the window is fixed in advance; warm-up requests are due before it
    win.t_end = base + warmup_s + seconds
    win.t_start = base + warmup_s

    opened = False

    def open_window():
        nonlocal opened
        opened = True
        if on_start is not None:
            on_start()
        win.completed0, win.batches0 = q.stats.completed, q.stats.batches
        _mark(sess, win, "start")

    sched = [(base + o, False) for o in warm] + [
        (win.t_start + o, True) for o in offs]
    for due, counted in sched:
        if counted and not opened:
            open_window()
        delay = due - CLOCK()
        if delay > 0:
            time.sleep(delay)
        rec = drv.submit(due)
        if counted:
            win.lateness.append(rec["submit"] - due)
    if not opened:
        open_window()
    delay = win.t_end - CLOCK()
    if delay > 0:
        time.sleep(delay)
    _mark(sess, win, "end")
    win.completed1, win.batches1 = q.stats.completed, q.stats.batches
    drv.wait_all(win.t_end + LATE_S)
    return win


def run_loop(sess: Session, q, seed: int, seconds: float, *, warm: bool,
             reservoir=None, on_start=None) -> Window:
    t = sess.traffic
    if t["loop"] == "closed":
        return closed_loop(sess, q, seed, seconds,
                           warmup=int(t["warmup_requests"]) if warm else 0,
                           reservoir=reservoir, on_start=on_start)
    return open_loop(sess, q, seed, seconds,
                     warmup_s=float(t["warmup_s"]) if warm else 0.0,
                     reservoir=reservoir, on_start=on_start)


class Context:
    """What a metric reader reads: the run's window, its records and
    probes, the session (until the program's state is freed) and the
    other metrics' values (``value``)."""

    def __init__(self, cell, sess: Session, win: Window, setup_s: float):
        self.cell = cell
        self.sess = sess
        self.win = win
        self.setup_s = setup_s
        self.probe = None          # DispatchProbe (traced runs)
        self.tracer = None
        self.profile = None        # the profiled window's reading
        self.notes: list = []      # lines for standard error
        self._values: dict = {}
        self._l1 = _UNSET

    def value(self, metric: str):
        """The value of ``metric`` (its reader runs once a run)."""
        if metric not in self._values:
            from hgcn_bench.spec import load_reader
            self._values[metric] = load_reader(metric)(self)
        return self._values[metric]

    # shared readings ---------------------------------------------------
    def layer1_operands(self):
        """Layer 1's X·W operands of one snapshot as the executor gets
        them, ``(x, w)``, from the model module's ``layer1_operands``;
        None where the module has none."""
        if self._l1 is _UNSET:
            s = self.sess
            hook = getattr(s.model, "layer1_operands", None)
            self._l1 = None if hook is None else hook(
                s.engine, s.name, s.handle, s.pool[0])
        return self._l1

    def latencies_ms(self) -> list:
        """Each counted request's latency from its due time to its
        resolution, ms; a failed or unresolved request is infinite."""
        out = []
        for r in self.win.counted():
            ok = r["ok"] and r["done"] is not None
            out.append((r["done"] - r["due"]) * 1e3 if ok else math.inf)
        return out

    def dispatch_rows(self) -> list:
        """The probe's dispatches enqueued inside the window."""
        if self.probe is None:
            return []
        return [row for row in self.probe.rows
                if self.win.t_start <= row[0] <= self.win.t_end]

    def dispatch_cover(self):
        """(busy s, window s) on the device's clock: the window between
        the events recorded at its open and close, and how much of it
        the union of the dispatches' [staging start, work end] intervals
        covers (gaps inside a dispatch count as busy). What a traced run
        reports as ``busy_s`` where the profiler saw nothing. None off
        the card."""
        win = self.win
        if win.ev_start is None or self.probe is None \
                or not self.probe.cuda:
            return None
        self.sess.torch.cuda.synchronize()
        span = win.ev_start.elapsed_time(win.ev_end) / 1e3
        if span <= 0:
            return None
        iv = [(win.ev_start.elapsed_time(e0) / 1e3,
               win.ev_start.elapsed_time(e1) / 1e3)
              for _, _, e0, e1 in self.dispatch_rows()]
        return yardstick.union_s(iv, 0.0, span), span


def _power_line() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def profile_window(ctx: Context, q, seed: int) -> dict:
    """A short ``torch.profiler`` window of the same traffic, after the
    measured one: the device's busy seconds in it, and the breakdown
    (device operations by time, idle gaps by what the host was doing).
    Returns {} where the profiler saw no device activity."""
    torch = ctx.sess.torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function("hgcn_bench.window"):
            run_loop(ctx.sess, q, seed + 7919, PROFILE_S, warm=False)
        torch.cuda.synchronize()
    evs = prof.events()
    win = [e for e in evs if e.name == "hgcn_bench.window"]
    dev = [e for e in evs
           if getattr(e, "device_type", None) is not None
           and str(e.device_type).endswith("CUDA")]
    if not win or not dev:
        return {}
    lo, hi = win[0].time_range.start / 1e6, win[0].time_range.end / 1e6
    iv = [(e.time_range.start / 1e6, e.time_range.end / 1e6) for e in dev]
    busy = yardstick.union_s(iv, lo, hi)
    by_name: dict = {}
    for e in dev:
        a, b = max(e.time_range.start / 1e6, lo), min(e.time_range.end / 1e6,
                                                      hi)
        if b > a:
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = [e for e in evs if e not in dev and e is not win[0]]
    gap_by: dict = {}
    for a, b in yardstick.gaps(iv, lo, hi):
        mid = (a + b) / 2 * 1e6
        inner = [e for e in host
                 if e.time_range.start <= mid <= e.time_range.end]
        what = min(inner, key=lambda e: e.time_range.end - e.time_range.start
                   ).name if inner else "host idle"
        gap_by[what] = gap_by.get(what, 0.0) + (b - a)
    idle = sorted(gap_by.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": hi - lo,
            "breakdown": {"device_ops": [[k, v] for k, v in ops],
                          "idle_gaps": [[k, v] for k, v in idle]}}


def compare(sess: Session, kept: list) -> tuple:
    """The largest ``logit_err`` of the kept outputs against the float64
    reference of their snapshots, and how many were compared."""
    torch = sess.torch
    ref = sess.model.reference(sess.atil, sess.device, "float64")
    by_snap: dict = {}
    for snap, y in kept:
        by_snap.setdefault(snap, []).append(y)
    worst = 0.0
    n = 0
    for snap in sorted(by_snap):
        want = ref.logits(sess.pool[snap], sess.weights)
        for y in by_snap[snap]:
            worst = max(worst, logit_err(y, want))
            n += 1
        del want
    del ref
    if sess.device.type == "cuda":
        torch.cuda.empty_cache()
    return worst, n


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_process: float = None,
             cache_dir=graphgen.CACHE_DIR) -> dict:
    """One run of ``cell`` (a ``spec.Cell``); returns the result line's
    object. Prints its notes and checks to standard error."""
    t_process = time.perf_counter() if t_process is None else t_process
    traffic_mod.check(cell.traffic)
    sess = Session(cell.config, cell.traffic, seed, device,
                   cache_dir=cache_dir)
    torch = sess.torch
    log(f"graph {sess.name}: {sess.n} vertices, {sess.nnz} nonzeros "
        f"({'cached' if sess.graph_cached else 'generated'} in "
        f"{sess.graph_s:.3f} s); register {sess.register_s:.3f} s; class "
        f"{sess.handle.sclass.summary()}")
    sess.warm()
    tracer = probe = None
    if trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer(capacity=1 << 19, sample_every=1, clock=CLOCK)
        probe = DispatchProbe(sess.engine, torch)
    q = sess.queue(tracer)
    reservoir = traffic_mod.Reservoir(int(cell.traffic["sample"]), seed)
    setup = {}

    def on_start():
        setup["s"] = time.perf_counter() - t_process

    try:
        win = run_loop(sess, q, seed, seconds, warm=True,
                       reservoir=reservoir, on_start=on_start)
        if sess.device.type == "cuda":
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() \
            if sess.device.type == "cuda" else 0
        ctx = Context(cell, sess, win, setup["s"])
        ctx.probe, ctx.tracer = probe, tracer
        if trace and sess.device.type == "cuda":
            ctx.profile = profile_window(ctx, q, seed)
    finally:
        q.stop()
    counted = win.counted()
    failed = sum(1 for r in counted if not r["ok"])
    failed += sum(1 for r in win.records if r["done"] is None)
    if win.lateness:
        late = sorted(win.lateness)
        log(f"generator lateness: median {np.median(late) * 1e3:.3f} ms, "
            f"max {late[-1] * 1e3:.3f} ms over {len(late)} submits")
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        v = ctx.value(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    for note in ctx.notes:
        log(note)
    cover = ctx.dispatch_cover() if trace and not ctx.profile else None
    kept = reservoir.items()
    ctx.sess = ctx.probe = ctx._l1 = reservoir = None
    del q, probe
    sess.free()
    err, n_cmp = compare(sess, kept)
    kept = None
    limit = float(cell.config["limits"]["logit_err"])
    checks = {"logit_err": {"value": err, "limit": limit},
              "failed": {"value": failed, "limit": 0},
              "compared": {"value": n_cmp, "limit": 1}}
    correct = (err <= limit and failed == 0 and n_cmp >= 1
               and len(counted) > 0)
    dev = {"platform": "gpu" if sess.device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(sess.device)
           if sess.device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(counted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and sess.device.type == "cuda":
        prof = ctx.profile or {}
        if prof:
            dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
            out["breakdown"] = prof["breakdown"]
        else:
            log("the profiler saw no device activity: no breakdown; busy_s "
                "is the dispatch events' union over the measured window")
            if cover is not None:
                dev["busy_s"], dev["window_s"] = cover
    if sess.device.type == "cuda":
        log(f"card: {_power_line()}")
    for k, c in checks.items():
        bound = "<=" if k != "compared" else ">="
        log(f"check {k}: {c['value']!r} {bound} {c['limit']!r}")
    out["checks"] = checks
    return out
