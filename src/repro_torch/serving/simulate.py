"""Deterministic scheduler simulation: synthetic traffic, no compiles.

Port of ``repro.serving.simulate``: the same stub engine, traces and
smokes, returning the same dicts. CI needs to exercise the
queue→scheduler→dispatch control flow on every push without building or
launching a single kernel or depending on wall-clock timing. This
module fakes the only two things the frontend touches — the clock
(`SimClock`) and the engine (`StubEngine`, a configurable service-time
model with the same ``handle`` / ``serve_group`` /
``executors.stats.misses`` surface) — so an entire arrival trace
replays in microseconds, bit-for-bit reproducibly.

Multi-replica simulation: ``StubEngine(..., replicas=N)`` models N
device timelines (`StubReplica`: per-replica ``device_free_s``,
configurable speed skew and a fault schedule that raises `ReplicaFault`
mid-window), and ``replica_view(i)`` hands each `ReplicaSet` lane a
view bound to its own timeline — `run_replica_smoke` and
`run_replica_fault_smoke` replay the same traces against 1 vs N
simulated replicas entirely offline.

The same replay loop (`replay_trace`) can drive the *real* engine: only
the clock and the dispatch target change between simulation and
production measurement.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np

from repro_torch.obs.metrics import percentile

from .chaos import NULL_INJECTOR, InjectedFault
from .frontend import AdmissionError, AdmissionPolicy, RequestQueue
from .replicas import ReplicaFault
from .scheduler import pow2_ceil
from .stats import SimClock


# ---------------------------------------------------------------------------
# Arrival traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Arrival:
    t_s: float
    name: str


def poisson_trace(n: int, rate_hz: float, names, seed: int = 0) -> list:
    """n arrivals with Exp(rate) gaps, names drawn uniformly."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate_hz))
        out.append(Arrival(t, names[int(rng.integers(len(names)))]))
    return out


def bursty_trace(n_bursts: int, burst: int, gap_s: float, names,
                 seed: int = 0, jitter_s: float = 0.0) -> list:
    """n_bursts bursts of ``burst`` near-simultaneous arrivals, gap_s
    apart — the arrival-time heterogeneity that starves call-at-a-time
    batching."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_bursts):
        t0 = i * gap_s
        for j in range(burst):
            t = t0 + (float(rng.exponential(jitter_s)) if jitter_s else 0.0)
            out.append(Arrival(t, names[int(rng.integers(len(names)))]))
    out.sort(key=lambda a: a.t_s)
    return out


# ---------------------------------------------------------------------------
# Stub engine: the frontend-facing Engine surface with modeled latency
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _StubHandle:
    name: str
    sclass: object
    weights: object
    size: int = 0      # modeled padded-MAC need (lifecycle simulation)


class _StubExecStats:
    def __init__(self):
        self.misses = 0


class _StubExecutors:
    def __init__(self):
        self.stats = _StubExecStats()


@dataclasses.dataclass(frozen=True)
class StubShapeClass:
    """Hashable one-number shape class for the lifecycle simulation:
    ``cap`` models total padded-MAC capacity per member; ``gen`` keeps
    same-capacity classes founded at different times distinct."""

    cap: int
    gen: int

    def summary(self) -> str:
        return f"StubClass cap={self.cap} gen={self.gen}"


@dataclasses.dataclass
class StubReplica:
    """One simulated device timeline inside a multi-replica `StubEngine`.

    ``speed`` scales the warm service rate (2.0 = twice as fast —
    replica skew for the router tests); ``fault_after`` is the dispatch
    count at which the replica dies: the NEXT dispatch raises
    `ReplicaFault`, and every batch already in flight raises the same
    fault from its completion hook (a device lost mid-window). Each
    replica warms its own ``compiled`` set — executors are per-device
    state, so a fresh replica pays its own compiles.
    """

    replica_id: int
    speed: float = 1.0
    fault_after: Optional[int] = None
    device_free_s: float = 0.0
    dead: bool = False
    dispatches: int = 0
    compiled: set = dataclasses.field(default_factory=set)


class _StubReplicaView:
    """The engine surface `DispatchPipeline` drives, bound to one
    replica's timeline — what ``StubEngine.replica_view`` returns and
    `ReplicaSet` wires one pipeline around."""

    def __init__(self, engine: "StubEngine", replica_id: int):
        self._engine = engine
        self.replica_id = replica_id

    def group_key(self, name: str, x) -> tuple:
        return self._engine.group_key(name, x)

    def handle(self, name: str):
        return self._engine.handle(name)

    @property
    def executors(self):
        return self._engine.executors

    def serve_group_async(self, requests, prepared=None) -> tuple:
        return self._engine.serve_group_async(
            requests, prepared, replica=self.replica_id)

    def serve_group(self, requests) -> list:
        return self._engine.serve_group(requests,
                                        replica=self.replica_id)


class StubEngine:
    """Engine stand-in: serve_group advances the SimClock by a modeled
    service time instead of running kernels.

    ``service_s(batch)`` models warm dispatch latency; the first dispatch
    of each (group key, padded batch) additionally pays ``compile_s`` and
    bumps the executor-cache miss counter — exactly the signal the
    frontend uses to keep cold samples out of the EWMA.

    Lifecycle surface: registering with a ``size`` switches the stub
    from the fixed ``sclass_of`` labeling to a one-dimensional class
    model mirroring the real `ClassRegistry` — first-fit into a live
    `StubShapeClass` whose capacity covers the size within
    ``fit_slack``× waste, else found a new class with ``growth``×
    headroom. The stub then implements the same
    ``class_waste_by_class`` / ``class_traffic`` / ``plan_retirement``
    / ``execute_retirement`` quartet as the real engine, so the
    `repro_torch.engine.lifecycle.LifecycleManager` runs against it
    unchanged — retirement, successor routing, and recompile
    accounting all exercise with zero real compiles.

    Replica surface: ``replicas=N`` models N independent device
    timelines (`StubReplica`), ``speeds`` maps replica_id -> rate
    multiplier, ``faults`` maps replica_id -> dispatch count after
    which that replica dies. ``replica_view(i)`` returns the per-lane
    view a `ReplicaSet` pipeline drives; the default single replica
    plus the ``device_free_s`` / ``_compiled`` properties keep every
    pre-replica caller byte-compatible.
    """

    def __init__(self, clock: SimClock, *, base_s: float = 0.004,
                 per_item_s: float = 0.001, compile_s: float = 0.25,
                 stage_s: float = 0.002, sclass_of=None,
                 growth: float = 2.0, fit_slack: float = 4.0,
                 replicas: int = 1, speeds=None, faults=None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.clock = clock
        self.base_s = base_s
        self.per_item_s = per_item_s
        self.compile_s = compile_s
        self.stage_s = stage_s
        self.growth = growth
        self.fit_slack = fit_slack
        speeds = speeds or {}
        if isinstance(speeds, (list, tuple)):
            speeds = dict(enumerate(speeds))
        faults = faults or {}
        self.replicas = [
            StubReplica(replica_id=i, speed=float(speeds.get(i, 1.0)),
                        fault_after=faults.get(i))
            for i in range(replicas)]
        self.executors = _StubExecutors()
        self._graphs: dict = {}
        self._sclass_of = sclass_of or (lambda name: "simclass")
        self.dispatches: list = []     # (key, batch, reason placeholder)
        self.classes: list = []        # live StubShapeClass, found order
        self._gen = 0
        self._traffic: dict = {}       # sclass -> dispatch count
        self.executors_invalidated = 0
        self._frontend = None
        self._lifecycle = None
        self.tracer = None     # set by attach_tracer (repro_torch.obs)
        # Chaos harness (repro_torch.serving.chaos): the stub owns every
        # injection site, including the "replica" kill the real Engine
        # can't simulate. NULL_INJECTOR keeps the default path to one
        # attribute check per dispatch.
        self.injector = NULL_INJECTOR

    # ------------------------------------------------- replica surface ----
    @property
    def device_free_s(self) -> float:
        """Back-compat single-device timeline == replica 0's."""
        return self.replicas[0].device_free_s

    @device_free_s.setter
    def device_free_s(self, v: float) -> None:
        self.replicas[0].device_free_s = v

    @property
    def _compiled(self) -> set:
        """Back-compat warm-executor set == replica 0's."""
        return self.replicas[0].compiled

    def replica_view(self, i: int) -> _StubReplicaView:
        """The per-replica engine view a `ReplicaSet` lane drives."""
        if not 0 <= i < len(self.replicas):
            raise IndexError(
                f"replica {i} out of range (have {len(self.replicas)})")
        return _StubReplicaView(self, i)

    # ------------------------------------------------------- offline ----
    def _fits(self, size: int, sc: StubShapeClass) -> bool:
        return size <= sc.cap <= self.fit_slack * size

    def _found(self, cap: int) -> StubShapeClass:
        sc = StubShapeClass(cap=int(cap), gen=self._gen)
        self._gen += 1
        self.classes.append(sc)
        return sc

    def register(self, name: str, size: int = 0) -> _StubHandle:
        if size > 0:
            sclass = next((sc for sc in self.classes
                           if self._fits(size, sc)), None)
            if sclass is None:
                sclass = self._found(self.growth * size)
        else:
            sclass = self._sclass_of(name)
        h = _StubHandle(name=name, sclass=sclass,
                        weights=[np.zeros((2, 2), np.float32)], size=size)
        self._graphs[name] = h
        return h

    def handle(self, name: str) -> _StubHandle:
        return self._graphs[name]

    def attach_frontend(self, frontend) -> None:
        self._frontend = frontend

    def attach_lifecycle(self, manager) -> None:
        self._lifecycle = manager

    def attach_tracer(self, tracer) -> None:
        """Same hook the real Engine exposes; the stub records no spans
        of its own (the frontend instruments around it) but keeping the
        attribute lets `LifecycleManager` emit retire/skip instants
        against stub-driven simulations too."""
        self.tracer = tracer

    def attach_injector(self, injector) -> None:
        """Same duck-typed hook the real Engine exposes
        (`repro_torch.serving.chaos`): every replica view shares the one
        injector, so site occurrence counters span the whole fleet."""
        self.injector = injector

    # -------------------------------------------------------- online ----
    def group_key(self, name: str, x) -> tuple:
        h = self._graphs[name]
        return (h.sclass, int(x.shape[1]),
                tuple(tuple(w.shape) for w in h.weights))

    def service_s(self, batch: int) -> float:
        return self.base_s + self.per_item_s * batch

    def serve_group_async(self, requests, prepared=None, *,
                          replica: int = 0) -> tuple:
        """Non-blocking dispatch against the modeled device timeline.

        Host-side cost (compile if cold, plus ``stage_s`` of staging)
        advances the SimClock — it occupies the pump/staging thread.
        Device-side cost occupies a separate per-replica
        ``device_free_s`` timeline: the batch starts when that device
        frees up and finishes ``service_s / speed`` later, so staging
        batch k+1 while batch k computes genuinely overlaps in virtual
        time — exactly the behavior the pipelined dispatch policy is
        CI-tested against with zero real compiles. The completion hook
        advances the clock to the finish instant (a host that waits),
        ``ready`` polls it.

        Fault schedule: a dead replica raises `ReplicaFault` here, and
        a replica whose ``fault_after`` budget is spent dies on this
        dispatch. Batches already enqueued when the replica dies raise
        the same fault from ``complete`` — lost mid-window, which is
        what the `ReplicaSet` rescue path is tested against.
        """
        rep = self.replicas[replica]
        if rep.dead:
            raise ReplicaFault(f"stub replica {replica} is dead")
        rep.dispatches += 1
        if rep.fault_after is not None and rep.dispatches > rep.fault_after:
            rep.dead = True
            raise ReplicaFault(
                f"stub replica {replica} died on dispatch "
                f"{rep.dispatches} (fault_after={rep.fault_after})")
        inj = self.injector
        if inj.enabled:
            if inj.poll("replica", replica=replica) is not None:
                rep.dead = True
                raise ReplicaFault(
                    f"stub replica {replica} killed by chaos injection")
            spec = inj.poll("dispatch", replica=replica)
            if spec is not None:
                raise InjectedFault(
                    "dispatch", transient=spec.mode == "transient",
                    detail=f"stub dispatch on replica {replica}")
        key = self.group_key(requests[0][0], requests[0][1])
        bs = pow2_ceil(len(requests))
        exec_key = (key, bs)
        cold = False
        if exec_key not in rep.compiled:
            if inj.enabled and inj.poll("compile", replica=replica) \
                    is not None:
                # the build never ran: the key stays cold, so a retry
                # recompiles (miss counted, same as the real cache)
                self.executors.stats.misses += 1
                raise InjectedFault(
                    "compile", detail=f"stub executor build bs={bs}")
            rep.compiled.add(exec_key)
            self.executors.stats.misses += 1
            self.clock.advance(self.compile_s)   # cold builds run host-side
            cold = True
        self.clock.advance(self.stage_s)         # pad/stack/enqueue
        start = max(self.clock(), rep.device_free_s)
        done = start + self.service_s(bs) / rep.speed
        hang = False
        if inj.enabled:
            spec = inj.poll("poison", replica=replica)
            if spec is not None:
                inj.mark_poisoned(requests[spec.member % len(requests)][0])
            hang = inj.poll("hang", replica=replica) is not None
        if not hang:
            # a hung batch never occupied the device: its timeline must
            # not delay subsequent dispatches on this replica
            rep.device_free_s = done
        self.dispatches.append((key, len(requests)))
        sc = key[0]
        self._traffic[sc] = self._traffic.get(sc, 0) + 1
        # deterministic output the tests can verify end-to-end
        outs = [x * 2.0 for _, x in requests]
        if inj.enabled and inj.poisoned_names():
            outs = [np.full_like(np.asarray(y), np.nan)
                    if inj.is_poisoned(nm) else y
                    for (nm, _), y in zip(requests, outs)]
        clock = self.clock

        if hang:
            def ready_hung() -> bool:
                return False

            def complete_hung() -> None:
                raise InjectedFault(
                    "hang", detail="completion forced on a hung dispatch")

            return outs, {"cold": cold, "ready": ready_hung,
                          "complete": complete_hung, "done_s": done}

        def ready() -> bool:
            return rep.dead or clock() >= done - 1e-12

        def complete() -> None:
            if rep.dead:
                raise ReplicaFault(
                    f"stub replica {rep.replica_id} died mid-window")
            if clock() < done:
                clock.advance(done - clock())

        return outs, {"cold": cold, "ready": ready, "complete": complete,
                      "done_s": done}

    def serve_group(self, requests, *, replica: int = 0) -> list:
        """Blocking dispatch: enqueue, then wait out the device — the
        serial discipline (host and device strictly alternate)."""
        outs, meta = self.serve_group_async(requests, replica=replica)
        meta["complete"]()
        return outs

    # ------------------------------------------------ lifecycle surface ----
    def class_waste_by_class(self) -> dict:
        """Same shape as ``Engine.class_waste_by_class`` (the fields the
        lifecycle consumes), from the one-number capacity model."""
        agg: dict = {}
        for h in self._graphs.values():
            if not isinstance(h.sclass, StubShapeClass):
                continue
            d = agg.setdefault(h.sclass, {"members": 0, "ell_nnz": 0})
            d["members"] += 1
            d["ell_nnz"] += h.size
        out: dict = {}
        for sc, d in agg.items():
            cap = sc.cap * d["members"]
            d["ell_capacity"] = cap
            d["padded_mac_waste_frac"] = (1.0 - d["ell_nnz"] / cap
                                          if cap else 0.0)
            out[sc] = d
        return out

    def class_traffic(self) -> dict:
        return dict(self._traffic)

    def plan_retirement(self, sc):
        from repro_torch.engine.lifecycle import RetirementPlan
        members = [h for h in self._graphs.values() if h.sclass == sc]
        if not members:
            return None
        members.sort(key=lambda h: (-h.size, h.name))
        live = [c for c in self.classes if c != sc]
        new: list = []
        targets: list = []
        for h in members:
            target = next((c for c in live if self._fits(h.size, c)), None)
            if target is None:
                target = next((c for c in new if self._fits(h.size, c)),
                              None)
            if target is None:
                # tight founding (growth 1.0), like the real registry's plan
                target = StubShapeClass(cap=h.size, gen=self._gen + len(new))
                new.append(target)
            targets.append(target)
        return RetirementPlan(sclass=sc,
                              names=tuple(h.name for h in members),
                              targets=tuple(targets),
                              new_classes=tuple(new))

    def execute_retirement(self, plan) -> dict:
        sc = plan.sclass
        if sc in self.classes:
            self.classes.remove(sc)
        moved = 0
        for name, target in zip(plan.names, plan.targets):
            h = self._graphs.get(name)
            if h is None or h.sclass != sc:
                continue
            if target not in self.classes:
                self.classes.append(target)
                self._gen = max(self._gen, target.gen + 1)
            h.sclass = target
            moved += 1
        # Invalidate the retired class's warm executors on EVERY
        # replica — `drain_class` has already quiesced all lanes, so
        # nothing can be serving a stale key while the sets shrink.
        dead = 0
        for rep in self.replicas:
            stale = [k for k in rep.compiled if k[0][0] == sc]
            for k in stale:
                rep.compiled.discard(k)
            dead += len(stale)
        self.executors_invalidated += dead
        return {"members": moved, "executors_invalidated": dead,
                "new_classes": len(plan.new_classes)}


# ---------------------------------------------------------------------------
# Replay loop — shared by the simulation smoke and the real benchmark
# ---------------------------------------------------------------------------

def attach_resolve_probe(queue, clock=None) -> dict:
    """Wrap ``queue.submit`` so every returned future records its
    resolution instant (on ``clock``, default the queue's) into the
    returned ``{id(future): t}`` dict. Sojourn — resolve time minus the
    trace's *intended* arrival — is the queue-delay metric the
    serial-vs-pipelined comparisons use: under overload a serial pump
    delays the submissions behind it, so submit→resolve latency alone
    cannot see that backlog. Used by `run_pipeline_smoke`; works on a
    real-engine queue too.
    """
    clock = clock or queue.clock
    resolve_at: dict = {}
    orig_submit = queue.submit

    def submit(name, x, deadline_ms=None, **kw):
        fut = orig_submit(name, x, deadline_ms=deadline_ms, **kw)
        fut.add_done_callback(
            lambda f: resolve_at.__setitem__(id(f), clock()))
        return fut

    queue.submit = submit
    return resolve_at

def replay_trace(queue: RequestQueue, trace, x_of, *, wait=None,
                 deadline_ms=None) -> tuple:
    """Synchronously replay ``trace`` through ``queue``.

    Between arrivals, any scheduler close that falls due fires at its
    due time, not at the next arrival — ``wait(until_s)`` owns the
    passage of time (SimClock.advance-based for simulation,
    sleep-based for real measurement). Returns (futures, rejected)
    aligned with the trace.
    """
    clock = queue.clock
    if wait is None:                       # simulation default
        def wait(until_s):
            if until_s > clock():
                clock.advance(until_s - clock())

    next_due = getattr(queue, "next_due_s", queue.scheduler.next_due_s)
    futures, rejected = [], []
    for arr in trace:
        while True:
            due = next_due(clock())
            if due is None or due >= arr.t_s:
                break
            wait(due)
            queue.pump()
        wait(arr.t_s)
        try:
            futures.append(queue.submit(arr.name, x_of(arr.name),
                                        deadline_ms=deadline_ms))
            rejected.append(False)
        except AdmissionError:
            futures.append(None)
            rejected.append(True)
        queue.pump()
    # rule (c): the trace is over — drain, honoring remaining deadlines.
    # Pipelined queues may owe in-flight batches even with nothing
    # pending, so the loop watches both; drain() flushes the window.
    inflight = getattr(queue, "inflight", lambda: 0)
    while queue.depth() or inflight():
        due = next_due(clock())
        if due is not None:
            wait(due)
        if not queue.pump():
            queue.drain()
    return futures, rejected


# ---------------------------------------------------------------------------
# The CI smoke
# ---------------------------------------------------------------------------

def run_smoke(verbose: bool = True) -> dict:
    """Deterministic end-to-end check of every closing rule + admission.

    Raises AssertionError on any invariant break; returns the stats
    snapshot for reporting.
    """
    clock = SimClock()
    engine = StubEngine(clock)
    names = [f"sim{i}" for i in range(4)]
    for n in names:
        engine.register(n)
    xs = {n: np.full((4, 3), float(i + 1), np.float32)
          for i, n in enumerate(names)}
    queue = RequestQueue(engine, target_batch=4, default_deadline_ms=500.0,
                         clock=clock)

    # Warm the stub's executor keys at every pow2 batch the queue can
    # dispatch — exactly what a production frontend does before taking
    # traffic, so compile time never lands inside a request's deadline.
    for bs in (1, 2, 4):
        engine.serve_group([(names[0], xs[names[0]])] * bs)

    # Phase 1 — a burst bigger than target_batch must close by SIZE.
    burst = bursty_trace(2, 6, 2.0, names[:1], seed=1)
    futs, _ = replay_trace(queue, burst, xs.__getitem__)
    assert queue.stats.close_reasons.get("size", 0) >= 2, \
        f"burst must close size-batches: {queue.stats.close_reasons}"

    # Phase 2 — sparse Poisson arrivals: lone requests must linger, then
    # close by DEADLINE slack, and still complete before their deadline.
    sparse = [Arrival(clock() + 1.0 + i, names[i % 4]) for i in range(6)]
    replay_trace(queue, sparse, xs.__getitem__)
    assert queue.stats.close_reasons.get("deadline", 0) >= 1, \
        f"sparse arrivals must deadline-close: {queue.stats.close_reasons}"

    # Phase 3 — dense Poisson traffic over all graphs.
    dense = poisson_trace(48, 200.0, names, seed=2)
    dense = [Arrival(a.t_s + clock() + 0.5, a.name) for a in dense]
    futs, _ = replay_trace(queue, dense, xs.__getitem__)
    for arr, f in zip(dense, futs):
        got = f.result(timeout=0)
        np.testing.assert_array_equal(got, xs[arr.name] * 2.0)

    snap = queue.stats.snapshot()
    assert snap["deadline_misses"] == 0, snap
    assert snap["completed"] == snap["arrivals"], snap
    assert snap["mean_batch"] > 1.0, \
        f"queue must batch Poisson traffic: {snap}"

    # Phase 4 — admission control: a zero-capacity policy rejects with
    # reason, and the rejection is counted.
    tight = RequestQueue(engine, target_batch=4, clock=clock,
                         admission=AdmissionPolicy(max_depth=2),
                         default_deadline_ms=500.0, attach=False)
    flood = [Arrival(clock(), names[0])] * 5
    _, rej = replay_trace(tight, flood, xs.__getitem__)
    tight.drain()
    assert not any(rej[:2]) and any(rej), \
        "overflow beyond max_depth must be rejected"
    assert tight.stats.rejected.get("depth", 0) >= 1

    if verbose:
        print("[sim] " + queue.stats.summary())
        print(f"[sim] batch_hist={snap['batch_hist']} "
              f"close_reasons={snap['close_reasons']} "
              f"latency_model={queue.latency.snapshot()}")
        print(f"[sim] admission: rejected={tight.stats.rejected}")
        print("[sim] scheduler-simulation smoke OK "
              f"(virtual time {clock():.2f}s, real compiles: 0)")
    return snap


def run_pipeline_smoke(verbose: bool = True,
                       trace_path: Optional[str] = None) -> dict:
    """Deterministic serial-vs-pipelined dispatch comparison
    plus the end-to-end tracing contract.

    The same bursty near-capacity trace replays through a serial queue
    and a pipelined one over identical `StubEngine` worlds. Serial
    dispatch pays ``stage_s + service_s`` per batch on one timeline, so
    the trace (whose bursts arrive faster than that) builds unbounded
    queue delay; the pipeline stages on the host timeline while the
    modeled device stream computes, keeping up. Queue delay is measured
    as **sojourn** — intended arrival to future resolution — because
    under overload the serial pump also delays the *submissions* behind
    it, which submit-to-resolve latency alone cannot see. The smoke
    asserts the acceptance contract with zero real compiles: outputs
    bitwise-equal between modes, >= 2x lower mean queue delay and no
    worse p99 when pipelined, zero added deadline misses, the in-flight
    window bound respected, and measured overlap.

    A third run replays the pipelined world with a `repro_torch.obs.trace`
    tracer attached and asserts the observability contract: outputs
    still bitwise-equal, virtual mean sojourn within 2% of the untraced
    run (the tracing-overhead gate — exact on `SimClock`, since tracer
    bookkeeping never advances virtual time), every span tree closed,
    and the span-measured overlap ratio within 10% of the pipeline's
    own ``overlap_ratio``. ``trace_path`` writes the Perfetto JSON
    there (tier-1 feeds it to ``scripts/trace_report.py``); None uses a
    throwaway file.
    """
    def run(pipelined: bool, traced: bool = False) -> tuple:
        clock = SimClock()
        engine = StubEngine(clock, base_s=0.004, per_item_s=0.001,
                            stage_s=0.004, compile_s=0.25)
        names = [f"p{i}" for i in range(4)]
        for n in names:
            engine.register(n)
        xs = {n: np.full((4, 3), float(i + 1), np.float32)
              for i, n in enumerate(names)}
        tracer = None
        if traced:
            from repro_torch.obs.trace import Tracer
            tracer = Tracer(capacity=1 << 15, clock=clock)
        queue = RequestQueue(engine, target_batch=4,
                             default_deadline_ms=800.0, clock=clock,
                             pipelined=pipelined, max_inflight=4,
                             tracer=tracer)
        for bs in (1, 2, 4):       # warm every pow2 the replay can hit
            engine.serve_group([(names[0], xs[names[0]])] * bs)
        resolve_at = attach_resolve_probe(queue)
        # bursts of 12 every 30ms: serial needs 3*(4+8)=36ms per burst
        # (overloaded), pipelined needs max(3*4 host, 3*8 device)=24ms
        trace = bursty_trace(40, 12, 0.030, names, seed=3)
        t0 = clock()
        trace = [Arrival(a.t_s + t0 + 0.05, a.name) for a in trace]
        futs, rej = replay_trace(queue, trace, xs.__getitem__)
        assert not any(rej), "default admission must admit the trace"
        queue.drain()
        outs = [np.asarray(f.result(timeout=0)) for f in futs]
        sojourn = np.array([resolve_at[id(f)] - a.t_s
                            for a, f in zip(trace, futs)])
        return queue, outs, sojourn, tracer

    q_serial, outs_serial, soj_serial, _ = run(pipelined=False)
    q_pipe, outs_pipe, soj_pipe, _ = run(pipelined=True)

    for i, (a, b) in enumerate(zip(outs_serial, outs_pipe)):
        assert np.array_equal(a, b), \
            f"request {i}: pipelined output differs bitwise from serial"

    snap_s = q_serial.stats.snapshot()
    snap_p = q_pipe.stats.snapshot()
    delay_s = float(soj_serial.mean()) * 1e3
    delay_p = float(soj_pipe.mean()) * 1e3
    assert delay_p * 2.0 <= delay_s, \
        f"pipelined mean queue delay {delay_p:.1f}ms must be >=2x lower " \
        f"than serial {delay_s:.1f}ms"
    # NB: snapshot p50/p99 measure submit->resolve; under overload the
    # serial pump delays the submissions themselves, so only the
    # sojourn percentiles are comparable across modes.
    assert percentile(soj_pipe, 99) <= percentile(soj_serial, 99), \
        "p99 sojourn must improve"
    assert snap_p["deadline_misses"] <= snap_s["deadline_misses"], \
        "pipelining must not add deadline misses"
    assert snap_p["deadline_misses"] == 0, snap_p
    assert 2 <= snap_p["inflight_peak"] <= 4, \
        f"window must fill but stay bounded: {snap_p['inflight_peak']}"
    assert q_pipe.inflight() == 0, "drain must leave nothing in flight"
    assert snap_p["overlap_ratio"] > 0.2, \
        f"pipeline must hide device time: {snap_p['overlap_ratio']}"
    assert snap_s["overlap_ratio"] == 0.0, \
        "serial dispatch hides nothing by construction"
    assert snap_p["staging_p50_ms"] > 0 and snap_p["device_p50_ms"] > 0
    assert snap_p["completed"] == snap_s["completed"] == len(outs_pipe)

    # --- traced re-run: the observability contract -------------------
    from repro_torch.obs.export import write_chrome_trace
    from repro_torch.obs.report import check_complete, overlap_check

    q_tr, outs_tr, soj_tr, tracer = run(pipelined=True, traced=True)
    for i, (a, b) in enumerate(zip(outs_pipe, outs_tr)):
        assert np.array_equal(a, b), \
            f"request {i}: traced output differs bitwise from untraced"
    delay_tr = float(soj_tr.mean()) * 1e3
    assert abs(delay_tr - delay_p) <= 0.02 * delay_p, \
        f"tracing overhead gate (<=2%): traced mean sojourn " \
        f"{delay_tr:.3f}ms vs {delay_p:.3f}ms untraced"
    assert not tracer.wrapped(), "the smoke trace must fit the ring"

    meta = {"serving": q_tr.stats.snapshot(),
            "pipeline": q_tr.pipeline.snapshot()}
    if trace_path is None:
        fd, tmp = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            doc = write_chrome_trace(tmp, tracer, metadata=meta)
        finally:
            os.unlink(tmp)
    else:
        doc = write_chrome_trace(trace_path, tracer, metadata=meta)
    problems = check_complete(doc)
    assert not problems, f"incomplete span trees: {problems}"
    ov = overlap_check(doc)
    assert ov["batches"] > 0, "traced run must record device windows"
    assert ov["ok"], \
        f"span-measured overlap {ov['measured']:.3f} not within 10% of " \
        f"reported {ov['reported']}"
    tracing = {"mean_sojourn_ms_off": delay_p,
               "mean_sojourn_ms_on": delay_tr,
               "overlap_measured": ov["measured"],
               "overlap_reported": ov["reported"],
               "events": len(doc["traceEvents"])}

    if verbose:
        print(f"[sim] serial:    {q_serial.stats.summary()}")
        print(f"[sim] pipelined: {q_pipe.stats.summary()}")
        print(f"[sim] mean queue delay {delay_s:.1f}ms -> {delay_p:.1f}ms "
              f"({delay_s / max(delay_p, 1e-9):.1f}x lower) | p99 sojourn "
              f"{percentile(soj_serial, 99) * 1e3:.1f} -> "
              f"{percentile(soj_pipe, 99) * 1e3:.1f}ms | "
              f"overlap={snap_p['overlap_ratio']:.2f} "
              f"inflight_peak={snap_p['inflight_peak']}")
        print(f"[sim] tracing: {tracing['events']} events, overlap "
              f"measured={ov['measured']:.3f} vs "
              f"reported={ov['reported']:.3f}, overhead "
              f"{delay_tr - delay_p:+.4f}ms"
              + (f", trace -> {trace_path}" if trace_path else ""))
        print("[sim] pipelined-dispatch smoke OK (outputs bitwise-equal, "
              "real compiles: 0)")
    return {"serial": snap_s, "pipelined": snap_p, "tracing": tracing}


def run_trace_smoke(verbose: bool = True,
                    trace_path: Optional[str] = None) -> dict:
    """Tracing smoke over the SERIAL dispatch path.

    Replays one deterministic world twice — tracer off, then on — and
    asserts the parts of the observability contract the pipelined smoke
    cannot reach: the serial ``dispatch``/``device`` span pair, rejected
    submissions (admission depth) tracing as immediately-closed roots
    with synthetic negative ids, and a deadline-missed request carrying
    ``missed: true`` on its root span. The overhead gate compares
    virtual mean latency between the runs (<= 2%; exact under
    `SimClock`, where tracer bookkeeping costs zero virtual time).
    """
    from repro_torch.obs.export import write_chrome_trace
    from repro_torch.obs.report import check_complete, spans
    from repro_torch.obs.trace import Tracer

    def run(traced: bool) -> tuple:
        clock = SimClock()
        engine = StubEngine(clock)
        names = [f"t{i}" for i in range(3)]
        for n in names:
            engine.register(n)
        xs = {n: np.full((4, 3), float(i + 1), np.float32)
              for i, n in enumerate(names)}
        tracer = Tracer(capacity=1 << 14, clock=clock) if traced else None
        queue = RequestQueue(engine, target_batch=4,
                             default_deadline_ms=500.0, clock=clock,
                             admission=AdmissionPolicy(max_depth=4),
                             tracer=tracer)
        for bs in (1, 2, 4):
            engine.serve_group([(names[0], xs[names[0]])] * bs)
        trace = bursty_trace(3, 4, 0.5, names, seed=5)
        t0 = clock()
        trace = [Arrival(a.t_s + t0 + 0.01, a.name) for a in trace]
        _, rej = replay_trace(queue, trace, xs.__getitem__)
        assert not any(rej), "the warm trace must be admitted in full"
        # admission rejects: submit past max_depth without pumping
        flood_futs, rejects = [], 0
        for _ in range(6):
            try:
                flood_futs.append(queue.submit(names[0], xs[names[0]]))
            except AdmissionError:
                rejects += 1
        assert rejects >= 1, "flood past max_depth must reject"
        queue.drain()
        assert all(f.done() for f in flood_futs)
        # deadline miss: an unseen feature width is a cold executor key,
        # so the dispatch pays compile_s=0.25s inside a 100ms deadline
        xm = np.full((4, 5), 1.0, np.float32)
        fm = queue.submit(names[0], xm, deadline_ms=100.0)
        queue.drain()
        assert fm.done()
        assert queue.stats.deadline_misses >= 1, \
            "the cold narrow-deadline request must miss"
        return queue, tracer

    q_off, _ = run(traced=False)
    q_on, tracer = run(traced=True)
    mean_off = q_off.stats.mean_latency_ms()
    mean_on = q_on.stats.mean_latency_ms()
    assert mean_off > 0
    assert abs(mean_on - mean_off) <= 0.02 * mean_off, \
        f"tracing overhead gate (<=2%): {mean_on:.3f}ms vs {mean_off:.3f}ms"
    assert q_on.stats.snapshot() == q_off.stats.snapshot(), \
        "tracing must not perturb any counter"
    assert not tracer.wrapped()

    meta = {"serving": q_on.stats.snapshot()}
    if trace_path is None:
        fd, tmp = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            doc = write_chrome_trace(tmp, tracer, metadata=meta)
        finally:
            os.unlink(tmp)
    else:
        doc = write_chrome_trace(trace_path, tracer, metadata=meta)
    problems = check_complete(doc)
    assert not problems, f"incomplete span trees: {problems}"
    roots = [s for s in spans(doc) if s["name"] == "request"]
    assert any(s["args"]["req"] < 0 and s["args"].get("rejected")
               for s in roots), \
        "rejected submissions must trace as closed roots"
    assert any(s["args"].get("missed") for s in roots), \
        "the deadline miss must be flagged on its request span"
    assert any(s["name"] == "dispatch" for s in spans(doc)), \
        "serial dispatch spans missing"

    out = {"mean_ms_off": mean_off, "mean_ms_on": mean_on,
           "requests": len(roots),
           "rejected": sum(1 for s in roots if s["args"]["req"] < 0),
           "events": len(doc["traceEvents"])}
    if verbose:
        print(f"[sim] trace smoke: {out['requests']} request roots "
              f"({out['rejected']} rejected), {out['events']} events, "
              f"mean latency {mean_off:.3f} -> {mean_on:.3f}ms"
              + (f", trace -> {trace_path}" if trace_path else ""))
        print("[sim] tracing smoke OK (closed span trees, <=2% overhead, "
              "real compiles: 0)")
    return out


def run_lifecycle_smoke(verbose: bool = True) -> dict:
    """Deterministic drift scenario for the shape-class lifecycle.

    A family of big graphs founds a class; the serving mix then drifts
    to smaller cousins that keep padding into the oversized class, so
    its rolling waste breaches the budget. The lifecycle must: hold off
    through the hysteresis window, drain the in-flight batch keyed on
    the retiring class (reason ``"retire"``, futures resolve — nothing
    strands), re-found the members tighter within the recompile budget,
    and route new submissions to the successor class. Zero real
    compiles; raises AssertionError on any invariant break.
    """
    from repro_torch.engine.lifecycle import LifecycleConfig, LifecycleManager

    clock = SimClock()
    engine = StubEngine(clock)
    queue = RequestQueue(engine, target_batch=4, default_deadline_ms=500.0,
                         clock=clock)
    cfg = LifecycleConfig(waste_budget=0.52, breach_windows=2,
                          max_retires_per_window=1,
                          max_recompiles_per_window=2, min_traffic=1,
                          cooldown_windows=2)
    mgr = LifecycleManager(engine, frontend=queue, config=cfg)

    big = [f"big{i}" for i in range(3)]
    for n in big:
        engine.register(n, size=100)     # founds StubClass cap=200
    x = np.full((4, 3), 1.0, np.float32)

    def serve(names):
        futs = [queue.submit(n, x) for n in names]
        queue.drain()
        assert all(f.done() for f in futs)
        return futs

    # Steady phase: 0.5 waste < budget -> no lifecycle action, ever.
    serve(big)
    w0 = mgr.step()
    assert w0["retired"] == [] and mgr.retires == 0
    assert len(engine.classes) == 1
    old_class = engine.classes[0]

    # Drift phase: smaller cousins pad into the oversized class.
    small = [f"small{i}" for i in range(4)]
    for n in small:
        engine.register(n, size=60)
    assert engine.handle(small[0]).sclass == old_class, \
        "drifted graphs must land in the oversized class for this smoke"
    waste_before = mgr.engine.class_waste_by_class()[old_class][
        "padded_mac_waste_frac"]
    assert waste_before > cfg.waste_budget

    # Window 1 of the breach: hysteresis must hold retirement back.
    serve(big + small)
    w1 = mgr.step()
    assert w1["retired"] == [], "breach_windows=2 means no retire yet"

    # Window 2: leave a batch IN FLIGHT on the retiring class, then
    # step. The retire barrier must flush it (reason "retire") before
    # the class vanishes — stranding it would hang these futures.
    serve(big + small)
    pending = [queue.submit(n, x) for n in small[:2]]
    assert queue.depth() == 2
    w2 = mgr.step()
    assert w2["retired"] == [mgr._summary(old_class)]
    assert all(f.done() for f in pending), \
        "retirement stranded in-flight requests"
    for f in pending:
        np.testing.assert_array_equal(f.result(timeout=0), x * 2.0)
    assert queue.stats.close_reasons.get("retire", 0) >= 1
    assert queue.depth() == 0

    # Members re-founded tighter, inside the recompile budget.
    assert old_class not in engine.classes
    assert w2["recompiles"] <= cfg.max_recompiles_per_window
    waste_after = max(
        (e["padded_mac_waste_frac"]
         for e in engine.class_waste_by_class().values()), default=0.0)
    assert waste_after < waste_before, (waste_after, waste_before)

    # New submissions route to the successor class (fresh group key).
    succ = engine.handle(big[0]).sclass
    assert succ != old_class
    fut = queue.submit(big[0], x)
    key = next(iter(queue.scheduler._pending))
    assert key[0] == succ, "post-retirement traffic must use the successor"
    queue.drain()
    np.testing.assert_array_equal(fut.result(timeout=0), x * 2.0)

    # Cooldown: the successor is immune even if budget were breached.
    w3 = mgr.step()
    assert w3["retired"] == []

    snap = mgr.snapshot()
    assert snap["retires"] == 1
    assert snap["reclassed_members"] == 7
    assert snap["recompiles"] <= cfg.max_recompiles_per_window
    assert queue.stats.dispatch_errors == 0
    if verbose:
        print(f"[sim] lifecycle: waste {waste_before:.3f} -> "
              f"{waste_after:.3f} | retires={snap['retires']} "
              f"reclassed={snap['reclassed_members']} "
              f"recompiles={snap['recompiles']} "
              f"drained={snap['drained_batches']}")
        print("[sim] lifecycle drift smoke OK "
              f"(virtual time {clock():.2f}s, real compiles: 0)")
    return snap


def _attach_order_probe(queue) -> list:
    """Wrap ``queue.submit`` so the returned list records ``id(future)``
    in RESOLUTION order — the per-key ordering oracle (resolve instants
    alone can tie on a SimClock; the callback sequence cannot)."""
    order: list = []
    orig_submit = queue.submit

    def submit(name, x, deadline_ms=None, **kw):
        fut = orig_submit(name, x, deadline_ms=deadline_ms, **kw)
        fut.add_done_callback(lambda f: order.append(id(f)))
        return fut

    queue.submit = submit
    return order


def _assert_key_order(trace, futs, order) -> None:
    """Within every group key (one per name here), resolution order
    must equal submit order — the `ReplicaSet` epoch-pinning contract."""
    rank = {fid: i for i, fid in enumerate(order)}
    by_name: dict = {}
    for arr, f in zip(trace, futs):
        by_name.setdefault(arr.name, []).append(rank[id(f)])
    for name, ranks in by_name.items():
        assert ranks == sorted(ranks), \
            f"key {name!r} resolved out of submit order: {ranks}"


def run_replica_smoke(verbose: bool = True, replicas: int = 4) -> dict:
    """Deterministic 1-vs-N replica comparison (the replica contract).

    The same bursty trace — heavy enough to saturate one simulated
    device — replays through a single-replica `ReplicaSet` and an
    N-replica one over identical `StubEngine` worlds on a `SimClock`.
    Four graph names map to four distinct shape classes, so the router
    has four independent group keys to spread across lanes while the
    key-epoch pin keeps each key's order intact. Asserts: outputs
    bitwise-equal between 1 and N replicas, per-key resolution order ==
    submit order in both, >= 3x aggregate throughput at N=4, zero
    deadline misses added, every replica routed work, and (traced
    re-run) device spans landing on >= 2 per-replica device tracks with
    every span tree closed. Zero real compiles.
    """
    def run(n: int, traced: bool = False) -> tuple:
        clock = SimClock()
        engine = StubEngine(clock, base_s=0.004, per_item_s=0.002,
                            stage_s=0.002, compile_s=0.25, replicas=n,
                            sclass_of=lambda name: name)
        names = [f"rep{i}" for i in range(4)]
        for nm in names:
            engine.register(nm)
        xs = {nm: np.full((4, 3), float(i + 1), np.float32)
              for i, nm in enumerate(names)}
        tracer = None
        if traced:
            from repro_torch.obs.trace import Tracer
            tracer = Tracer(capacity=1 << 16, clock=clock)
        queue = RequestQueue(engine, target_batch=4,
                             default_deadline_ms=2000.0, clock=clock,
                             replicas=n, max_inflight=4, tracer=tracer)
        # Warm every replica at every pow2 batch the replay can hit —
        # executors are per-device state, so each lane pays its own.
        for i in range(n):
            for bs in (1, 2, 4):
                for nm in names:
                    engine.serve_group([(nm, xs[nm])] * bs, replica=i)
        order = _attach_order_probe(queue)
        # bursts of 12 every 8ms: one device owes 3 closed 4-batches
        # (3 x 12ms) per 8ms of arrivals — saturated; four devices
        # retire it in step. Names rotate round-robin over the bursty
        # arrival times so all four keys carry equal load (the router
        # spreads KEYS, so a lopsided key would serialize on its lane
        # and measure the straggler, not the fleet).
        trace = bursty_trace(40, 12, 0.008, names, seed=3)
        t0 = clock()
        trace = [Arrival(a.t_s + t0 + 0.05, names[i % len(names)])
                 for i, a in enumerate(trace)]
        futs, rej = replay_trace(queue, trace, xs.__getitem__)
        assert not any(rej), "default admission must admit the trace"
        queue.drain()
        makespan = clock() - trace[0].t_s
        outs = [np.asarray(f.result(timeout=0)) for f in futs]
        _assert_key_order(trace, futs, order)
        return queue, outs, makespan, tracer

    q1, outs1, makespan1, _ = run(1)
    qn, outsn, makespann, _ = run(replicas)

    for i, (a, b) in enumerate(zip(outs1, outsn)):
        assert np.array_equal(a, b), \
            f"request {i}: {replicas}-replica output differs bitwise " \
            f"from single-replica"

    snap1 = q1.stats.snapshot()
    snapn = qn.stats.snapshot()
    assert snap1["deadline_misses"] == 0, snap1
    assert snapn["deadline_misses"] == 0, \
        f"replicas must not add deadline misses: {snapn}"
    assert snapn["completed"] == snap1["completed"] == len(outsn)

    tput1 = len(outs1) / makespan1
    tputn = len(outsn) / makespann
    speedup = tputn / tput1
    assert speedup >= 3.0, \
        f"{replicas} replicas must give >=3x throughput: " \
        f"{tput1:.0f} -> {tputn:.0f} rps ({speedup:.2f}x)"

    rsnap = snapn["replicas"]
    assert rsnap["count"] == replicas, rsnap
    served = [r for r, d in rsnap["per_replica"].items()
              if d["batches"] > 0]
    assert len(served) >= 2, \
        f"router must spread keys across replicas: {rsnap['per_replica']}"
    assert rsnap["faults"] == 0 and rsnap["requeued"] == 0
    assert qn.replica_set.healthy_count() == replicas

    # --- traced re-run: per-replica device tracks in the export --------
    from repro_torch.obs.export import write_chrome_trace
    from repro_torch.obs.report import check_complete

    q_tr, outs_tr, _, tracer = run(replicas, traced=True)
    for i, (a, b) in enumerate(zip(outsn, outs_tr)):
        assert np.array_equal(a, b), \
            f"request {i}: traced output differs bitwise from untraced"
    assert not tracer.wrapped(), "the smoke trace must fit the ring"
    fd, tmp = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        doc = write_chrome_trace(
            tmp, tracer, metadata={"serving": q_tr.stats.snapshot()})
    finally:
        os.unlink(tmp)
    problems = check_complete(doc)
    assert not problems, f"incomplete span trees: {problems}"
    device_tids = {ev["tid"] for ev in doc["traceEvents"]
                   if ev["ph"] == "X" and ev["cat"] == "device"}
    assert len(device_tids) >= 2, \
        f"device spans must land on per-replica tracks: {device_tids}"

    out = {"replicas": replicas,
           "completed": snapn["completed"],
           "throughput_rps_1": tput1,
           "throughput_rps_n": tputn,
           "replica_speedup_x": speedup,
           "makespan_s_1": makespan1,
           "makespan_s_n": makespann,
           "replicas_served": len(served),
           "key_epochs": rsnap["key_epochs"],
           "per_replica_util": {
               r: d["device_span_s"] / makespann
               for r, d in rsnap["per_replica"].items()},
           "device_tracks": len(device_tids)}
    if verbose:
        util = " ".join(f"r{r}={u:.2f}"
                        for r, u in sorted(out["per_replica_util"].items()))
        print(f"[sim] replicas: {tput1:.0f} -> {tputn:.0f} rps "
              f"({speedup:.2f}x at {replicas} replicas) | "
              f"makespan {makespan1 * 1e3:.0f} -> "
              f"{makespann * 1e3:.0f}ms | util {util}")
        print(f"[sim] replica routing: {len(served)}/{replicas} lanes "
              f"served, key_epochs={rsnap['key_epochs']}, "
              f"{len(device_tids)} device tracks in the trace")
        print("[sim] replica smoke OK (outputs bitwise-equal, per-key "
              "order preserved, real compiles: 0)")
    return out


def run_replica_fault_smoke(verbose: bool = True) -> dict:
    """Fault-injection contract: a replica that dies mid-window strands
    nothing.

    Three simulated replicas take the trace; replica 1's fault schedule
    kills it partway through. The `ReplicaSet` must mark it unhealthy,
    drain its in-flight window (every batch fails at completion),
    requeue all rescued members onto survivors in submit order, and
    shrink admission capacity to the surviving lanes. Asserts: every
    future resolves with the correct value (zero stranded), per-key
    order holds across the migration, at most one duplicate dispatch
    suppressed, healthy count drops to 2, and
    `AdmissionPolicy.effective_depth` tracks it. Zero real compiles.
    """
    clock = SimClock()
    names = [f"flt{i}" for i in range(3)]
    # 9 warm dispatches land on each replica before traffic; replica 1
    # then dies on its 5th trace-driven dispatch — mid-trace, with work
    # in flight.
    engine = StubEngine(clock, base_s=0.004, per_item_s=0.001,
                        stage_s=0.002, compile_s=0.25, replicas=3,
                        faults={1: 13}, sclass_of=lambda name: name)
    for nm in names:
        engine.register(nm)
    xs = {nm: np.full((4, 3), float(i + 1), np.float32)
          for i, nm in enumerate(names)}
    queue = RequestQueue(engine, target_batch=4,
                         default_deadline_ms=2000.0, clock=clock,
                         replicas=3, max_inflight=4)
    for i in range(3):
        for bs in (1, 2, 4):
            for nm in names:
                engine.serve_group([(nm, xs[nm])] * bs, replica=i)
    order = _attach_order_probe(queue)
    trace = bursty_trace(20, 9, 0.010, names, seed=7)
    t0 = clock()
    trace = [Arrival(a.t_s + t0 + 0.05, a.name) for a in trace]
    futs, rej = replay_trace(queue, trace, xs.__getitem__)
    assert not any(rej), "default admission must admit the trace"
    queue.drain()

    # Zero stranded futures: everything resolves, with correct values —
    # rescued members were re-dispatched, not failed.
    assert all(f.done() for f in futs), "fault stranded futures"
    for arr, f in zip(trace, futs):
        np.testing.assert_array_equal(f.result(timeout=0),
                                      xs[arr.name] * 2.0)
    _assert_key_order(trace, futs, order)
    assert queue.depth() == 0 and queue.inflight() == 0

    rs = queue.replica_set
    assert rs.healthy_count() == 2, \
        f"replica 1 must be marked unhealthy: {rs.snapshot()}"
    assert not rs.replica(1).healthy
    rsnap = queue.stats.replica_snapshot()
    assert rsnap["faults"] >= 1, rsnap
    assert rsnap["requeued"] >= 1, \
        f"the dead replica's window must requeue: {rsnap}"
    assert rsnap["dup_suppressed"] <= 1, \
        f"at most one duplicate dispatch suppressed: {rsnap}"
    snap = queue.stats.snapshot()
    assert snap["completed"] == len(futs)
    assert snap["deadline_misses"] == 0, snap

    # Admission capacity shrinks with the healthy count.
    pol = AdmissionPolicy(max_depth=8)
    assert queue._healthy_replicas() == 2
    assert pol.effective_depth(queue._healthy_replicas()) == 16 \
        < pol.effective_depth(3)

    out = {"replicas": 3, "healthy": rs.healthy_count(),
           "completed": snap["completed"],
           "faults": rsnap["faults"], "requeued": rsnap["requeued"],
           "dup_suppressed": rsnap["dup_suppressed"],
           "key_epochs": rsnap["key_epochs"]}
    if verbose:
        print(f"[sim] fault: replica 1 died mid-window -> "
              f"{rsnap['requeued']} members requeued, "
              f"{rsnap['dup_suppressed']} dup suppressed, "
              f"{snap['completed']}/{len(futs)} completed, "
              f"healthy {rs.healthy_count()}/3")
        print("[sim] replica fault smoke OK (zero stranded futures, "
              "admission capacity shrunk, real compiles: 0)")
    return out


def run_chaos_smoke(verbose: bool = True) -> dict:
    """End-to-end failure containment under a seeded chaos schedule
    (the failure-containment contract; see docs/ROBUSTNESS.md).

    A three-replica `StubEngine` world takes a bursty trace while a
    `ChaosInjector` fires every site in the taxonomy at deterministic
    occurrence indices: a transient dispatch raise (inline retry with
    backoff), an injected compile failure (retry recompiles), a hung
    device future (the dispatch watchdog converts it into a retryable
    `WatchdogTimeout`), a poisoned member (quarantine bisection fails
    exactly the offending request name with `PoisonedRequest`; its
    batch-mates resolve bitwise-equal to the fault-free oracle), and a
    replica kill (the `ReplicaSet` rescue path). A second phase
    floods the queue to trip the `BrownoutController`: best-effort
    submissions shed deterministically while a guaranteed request is
    admitted and served; draining the backlog recovers admission.

    Asserts: zero stranded futures, every failed future carries
    `PoisonedRequest` for the one poisoned name, every other output
    bitwise-equal to ``x * 2.0``, per-key resolution order preserved,
    the shed count exactly matches the deterministic expectation, and
    all five sites actually fired. Zero real compiles.
    """
    from .chaos import SITES, ChaosInjector, FaultPlan, FaultSpec
    from .resilience import BrownoutController, PoisonedRequest

    clock = SimClock()
    # Two shape classes over four names -> mixed-name batches inside
    # each class, so quarantine bisection has innocent batch-mates to
    # exonerate; two group keys keep two replica lanes busy.
    names = ["cxa0", "cxa1", "cxb0", "cxb1"]
    engine = StubEngine(clock, base_s=0.004, per_item_s=0.001,
                        stage_s=0.002, compile_s=0.25, replicas=3,
                        sclass_of=lambda name: name[:3])
    for nm in names:
        engine.register(nm)
    xs = {nm: np.full((4, 3), float(i + 1), np.float32)
          for i, nm in enumerate(names)}
    # Warm class "cxa" on every replica; leave "cxb" cold so the
    # injected compile failure has a real cold build to land on.
    for i in range(3):
        for bs in (1, 2, 4):
            engine.serve_group([("cxa0", xs["cxa0"])] * bs, replica=i)

    plan = FaultPlan((
        FaultSpec(site="compile", at=0),             # first cold build fails
        FaultSpec(site="dispatch", at=5),            # transient raise -> retry
        FaultSpec(site="hang", at=12),               # watchdog must fire
        FaultSpec(site="poison", at=18, member=1),   # one name goes toxic
        FaultSpec(site="replica", at=30),            # a lane dies mid-trace
        FaultSpec(site="dispatch", at=40),           # retry again, late
    ))
    injector = ChaosInjector(plan)
    brownout = BrownoutController(high_depth=48, low_depth=8)
    queue = RequestQueue(engine, target_batch=4,
                         default_deadline_ms=2000.0, clock=clock,
                         replicas=3, max_inflight=4,
                         injector=injector, resilience=True,
                         brownout=brownout)
    order = _attach_order_probe(queue)

    # Phase 1 — the chaos trace: every site fires while traffic flows.
    trace = bursty_trace(20, 9, 0.010, names, seed=7)
    t0 = clock()
    trace = [Arrival(a.t_s + t0 + 0.05, a.name) for a in trace]
    futs, rej = replay_trace(queue, trace, xs.__getitem__)
    assert not any(rej), "phase 1 must not shed (depth stays under high)"
    queue.drain()
    assert queue.depth() == 0 and queue.inflight() == 0
    assert all(f.done() for f in futs), "chaos stranded futures"

    poisoned = injector.poisoned_names()
    assert len(poisoned) == 1, f"exactly one name goes toxic: {poisoned}"
    n_quarantined = 0
    for arr, f in zip(trace, futs):
        err = f.exception(timeout=0)
        if err is not None:
            assert isinstance(err, PoisonedRequest), \
                f"only quarantine may fail a future: {err!r}"
            assert arr.name in poisoned, \
                f"innocent request {arr.name!r} quarantined"
            n_quarantined += 1
        else:
            np.testing.assert_array_equal(f.result(timeout=0),
                                          xs[arr.name] * 2.0)
    assert n_quarantined >= 1, "the poison fault must quarantine someone"
    _assert_key_order(trace, futs, order)

    fired_sites = {s for s, _ in injector.fired()}
    assert fired_sites == set(SITES), \
        f"every site must fire: missing {set(SITES) - fired_sites}"
    snap = queue.stats.snapshot()
    res = snap["resilience"]
    assert res["retries"] >= 1, res
    assert res["quarantined"] == n_quarantined >= 1, res
    assert res["watchdog_fires"] >= 1, res
    assert queue.replica_set.healthy_count() == 2, \
        "the injected replica kill must mark one lane unhealthy"
    assert snap["replicas"]["requeued"] >= 1, snap["replicas"]

    # Phase 2 — brownout: flood past the high watermark without
    # pumping. Depth at submit i is exactly i, so submissions at depth
    # >= high_depth shed deterministically, in submit order.
    n_flood = 60
    flood_futs = []
    for i in range(n_flood):
        try:
            flood_futs.append(queue.submit(names[i % len(names)],
                                           xs[names[i % len(names)]]))
        except AdmissionError as e:
            assert e.reason == "brownout", e
    expect_shed = n_flood - brownout.high_depth
    shed = queue.stats.snapshot()["resilience"]["shed"]
    assert shed == expect_shed, \
        f"shed count must be deterministic: {shed} != {expect_shed}"
    assert brownout.active, "flood must trip the brownout"
    g = queue.submit("cxa0", xs["cxa0"], guaranteed=True)
    queue.drain()
    assert g.done(), "guaranteed traffic must serve through brownout"
    if g.exception(timeout=0) is None:
        np.testing.assert_array_equal(g.result(timeout=0),
                                      xs["cxa0"] * 2.0)
    for f in flood_futs:
        assert f.done(), "brownout stranded an admitted future"
    # depth is back to zero: the next best-effort submit both recovers
    # the controller (hysteresis low watermark) and is admitted
    f2 = queue.submit("cxa0", xs["cxa0"])
    assert not brownout.active, "drained queue must recover admission"
    queue.drain()
    assert f2.done()

    rescued = queue._resilience.rescued
    out = {"completed": queue.stats.snapshot()["completed"],
           "requests": len(futs),
           "chaos_rescued": rescued,
           "chaos_shed": shed,
           "quarantined": n_quarantined,
           "retries": res["retries"],
           "watchdog_fires": res["watchdog_fires"],
           "faults_fired": len(injector.fired()),
           "healthy": queue.replica_set.healthy_count()}
    if verbose:
        print(f"[sim] chaos: {len(injector.fired())} faults fired over "
              f"{len(futs)} requests -> {rescued} rescued, "
              f"{n_quarantined} quarantined ({sorted(poisoned)}), "
              f"{res['retries']} retries, "
              f"{res['watchdog_fires']} watchdog fires, "
              f"healthy {queue.replica_set.healthy_count()}/3")
        print(f"[sim] brownout: {shed} best-effort shed "
              f"(deterministic), guaranteed request served, "
              f"admission recovered after drain")
        print("[sim] chaos smoke OK (zero stranded futures, quarantine "
              "isolated the poisoned member, real compiles: 0)")
    return out
