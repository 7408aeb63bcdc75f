"""The standing request queue: async frontend over the shape-class Engine.

Port of ``repro.serving.frontend``. Turns `Engine` (register once,
answer calls) into a server (accept traffic continuously, batch
opportunistically):

  submit(name, x, deadline_ms) ──▶ admission control ──▶ per-group
  pending queue ──▶ `Scheduler` closes a batch (size / deadline slack /
  drain) ──▶ one `Engine.serve_group_async` dispatch through the cached
  group executor, then a wait on its completion hook ──▶ futures
  resolve.

The queue is synchronous at heart — ``pump()`` closes and dispatches
everything due *now*, ``drain()`` flushes — so replays and tests drive
it deterministically on a `SimClock`. ``start()`` wraps the same pump in
a daemon thread for real async serving: submitters block only for
admission control, and the worker wakes on submission or when the
scheduler forecasts the next deadline close.

Dispatch wall time, enqueue through device completion, feeds the EWMA
`LatencyModel`; dispatches that built an executor (detected via the
engine's cache-miss counter) are reported cold and excluded, so one cold
build can't poison the deadline rule. All counters land in
`ServerStats`, surfaced through ``Engine.stats()["serving"]``.

Two dispatch disciplines:

  serial     (default) — each closed batch runs end-to-end (stage,
             enqueue, block) before the next; simple, and the baseline
             the pipeline is benchmarked against.
  pipelined  (``pipelined=True``) — closed batches flow through a
             `DispatchPipeline`: host staging overlaps device compute
             behind a bounded in-flight window, the EWMA learns
             staging/device segments separately, and admission wait
             accounts for the in-flight work the scheduler can't see.
             Outputs stay bitwise-equal to serial dispatch (same
             grouping, same executors, per-key order preserved).

A third discipline stacks on the pipelined one: ``replicas=N`` routes
closed batches across N per-device pipelines through a `ReplicaSet`
(least-loaded routing, key-epoch pinning for per-key order, fault
requeue — see :mod:`repro_torch.serving.replicas`). Admission then
aggregates fleet capacity: the depth budget scales with the healthy
replica count (`AdmissionPolicy.effective_depth`), the scheduler backlog
drains N-wide, and the in-flight wait term is the min-over-replicas
backlog.
"""
from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Optional

from repro_torch.obs.trace import NULL_TRACER, label

from .latency import LatencyModel
from .pipeline import DispatchPipeline
from .replicas import ReplicaSet
from .resilience import (ResilienceCoordinator, outputs_finite,
                         sync_dispatch_fn)
from .scheduler import Scheduler, pow2_ceil
from .stats import ServerStats

DEFAULT_DEADLINE_MS = 2000.0


class AdmissionError(RuntimeError):
    """Request rejected at submit; ``reason`` names the exceeded budget."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"admission rejected ({reason}): {detail}")
        self.reason = reason


class RequestFuture(concurrent.futures.Future):
    """Future for one submitted request — the stdlib `Future` used
    executor-less (thread-safe set_result/set_exception/result(timeout),
    plus done-callbacks and ``cancel()``: a request cancelled while
    still pending never resolves, and the dispatch path skips it)."""


class AdmissionPolicy:
    """Budgets checked at ``submit`` time; ``None`` disables a check.

    Admission control sheds load *at the door* — a request that cannot
    be served inside its deadline is cheaper to reject immediately than
    to queue, time out, and still consume a dispatch slot. Two budgets:

    ``max_depth``
        Cap on total pending requests across every group key. Exceeding
        it rejects with reason ``"depth"``. This is the memory/backlog
        bound: each pending request pins its feature array.
    ``max_wait_ms``
        Cap on the *estimated* service wait (milliseconds) the request
        would face — the serial dispatch latency of every batch already
        pending across **all** keys plus the batch the request joins
        (`Scheduler.estimated_wait_s`). Exceeding it rejects with
        reason ``"wait"``. This is the latency bound: it refuses work
        that would miss its deadline anyway.

    A third reject reason, ``"stopped"``, is raised by the queue itself
    after ``stop()``: no worker will ever dispatch, so admitting would
    strand the future until its timeout. Every rejection is counted per
    reason in ``ServerStats.rejected`` and raises `AdmissionError` with
    the machine-readable ``.reason``.
    """

    def __init__(self, max_depth: Optional[int] = 1024,
                 max_wait_ms: Optional[float] = None):
        self.max_depth = max_depth
        self.max_wait_ms = max_wait_ms

    def effective_depth(self, replicas: int = 1) -> Optional[int]:
        """Aggregate backlog budget: ``max_depth`` is a per-replica
        window, so the fleet-level cap sums it over healthy replicas —
        and shrinks again when the router marks a replica unhealthy.

        >>> AdmissionPolicy(max_depth=8).effective_depth(4)
        32
        >>> AdmissionPolicy(max_depth=8).effective_depth()
        8
        >>> AdmissionPolicy(max_depth=None).effective_depth(4) is None
        True
        """
        if self.max_depth is None:
            return None
        return self.max_depth * max(1, int(replicas))


class RequestQueue:
    """Standing request queue with deadline-based batch closing."""

    def __init__(self, engine, *, target_batch: int = 8,
                 default_deadline_ms: float = DEFAULT_DEADLINE_MS,
                 admission: Optional[AdmissionPolicy] = None,
                 latency_model: Optional[LatencyModel] = None,
                 safety_factor: float = 2.0,
                 max_linger_ms: Optional[float] = None,
                 clock=time.monotonic, attach: bool = True,
                 pipelined: bool = False, max_inflight: int = 4,
                 stage_workers: int = 1, adaptive_inflight: bool = False,
                 tracer=None, replicas: Optional[int] = None,
                 injector=None, resilience=None, brownout=None):
        self.engine = engine
        self.clock = clock
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.default_deadline_ms = default_deadline_ms
        self.admission = admission if admission is not None \
            else AdmissionPolicy()
        self.stats = ServerStats()
        # ``replicas=N`` implies pipelined dispatch: the ReplicaSet owns
        # one pipeline + LatencyModel per replica and exposes the same
        # driving surface; the queue-level model becomes the read-only
        # min-over-replicas aggregate (a caller-supplied latency_model
        # is ignored — per-replica observation is the whole point).
        self.replica_set: Optional[ReplicaSet] = None
        if replicas is not None:
            self.replica_set = ReplicaSet(
                engine, replicas, stats=self.stats, clock=self.clock,
                max_inflight=max_inflight, stage_workers=stage_workers,
                adaptive_inflight=adaptive_inflight, tracer=self.tracer)
            self.latency = self.replica_set.latency
        else:
            self.latency = latency_model if latency_model is not None \
                else LatencyModel(
                    prior=getattr(engine, "latency_prior", None))
        self.scheduler = Scheduler(
            self.latency, target_batch=target_batch,
            safety_factor=safety_factor,
            max_linger_s=None if max_linger_ms is None
            else max_linger_ms / 1e3)
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        # Serializes dispatches across threads. Lock order is always
        # _lock -> _dispatch_gate; a gate holder never takes _lock, so
        # drain_class may hold both without deadlock. The normal pump
        # path takes only the gate (submits stay unblocked during a
        # dispatch); drain_class takes _lock first so the queue is
        # frozen while a retiring class drains and swaps.
        self._dispatch_gate = threading.Lock()
        self.pipeline: Optional[DispatchPipeline] = None
        if self.replica_set is not None:
            self.pipeline = self.replica_set
            self.stats.pipelined = True
        elif pipelined:
            self.pipeline = DispatchPipeline(
                engine, latency=self.latency, stats=self.stats,
                clock=self.clock, max_inflight=max_inflight,
                stage_workers=stage_workers,
                adaptive_inflight=adaptive_inflight,
                tracer=self.tracer)
            self.stats.pipelined = True
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        if attach:
            attach_fn = getattr(engine, "attach_frontend", None)
            if attach_fn is not None:
                attach_fn(self)
        if tracer is not None:
            # engine-side instrumentation (pad spans, cache hit/miss,
            # autotune sweeps) reports into the same ring
            attach_tr = getattr(engine, "attach_tracer", None)
            if attach_tr is not None:
                attach_tr(tracer)
        # chaos-injection wiring mirrors the tracer: the engine owns the
        # actual injection sites (dispatch/compile/hang/poison/replica),
        # the queue just hands the injector down
        if injector is not None:
            attach_inj = getattr(engine, "attach_injector", None)
            if attach_inj is not None:
                attach_inj(injector)
        # failure containment (docs/ROBUSTNESS.md): a coordinator wraps
        # every pipeline's fail handler (after the ReplicaSet's, which
        # keeps first claim on ReplicaFault), arms per-pipeline
        # watchdogs, and serves the serial dispatch path. `brownout`
        # adds SLO-aware load shedding at admission. Both default off —
        # the disabled paths cost one attribute check.
        self.brownout = brownout
        self._resilience: Optional[ResilienceCoordinator] = None
        if resilience:
            if resilience is True:
                resilience = ResilienceCoordinator(
                    stats=self.stats, clock=self.clock, tracer=self.tracer)
            resilience.install(self)

    # ---------------------------------------------------------- submit ----
    def _group_key(self, name: str, x) -> tuple:
        # delegated: the engine's group_key is the single source of
        # truth for what may share one serve_group dispatch
        return self.engine.group_key(name, x)

    def submit(self, name: str, x,
               deadline_ms: Optional[float] = None,
               guaranteed: bool = False) -> RequestFuture:
        """Queue one inference request for graph ``name`` with features
        ``x``; returns a `RequestFuture` that resolves to the logits.

        Deadline semantics
            ``deadline_ms`` (default: the queue's ``default_deadline_ms``)
            is a **relative soft deadline**: the request's absolute
            deadline is ``now + deadline_ms / 1e3`` on the queue's
            clock, fixed at submit. The scheduler lingers the request
            for batch occupancy only while the tightest deadline in its
            group retains more slack than ``safety_factor ×`` the
            EWMA-estimated dispatch latency, so under honest estimates
            the result lands before the deadline. The deadline is not a
            hard timeout: a late result is still delivered, and the
            overrun is counted in ``ServerStats.deadline_misses``.
            ``future.result(timeout=...)`` is the caller's hard bound.

        Admission
            Budgets are checked before queueing; a violation raises
            `AdmissionError` instead of returning a future — ``.reason``
            is ``"depth"`` (queue backlog cap), ``"wait"`` (estimated
            cross-key service wait exceeds ``max_wait_ms``),
            ``"stopped"`` (the queue was stopped), or ``"brownout"``
            (overload shedding active and the request is best-effort —
            ``guaranteed=True`` traffic is exempt; see
            `repro_torch.serving.resilience.BrownoutController`). Rejected
            requests do not count as arrivals.

        Grouping
            The request joins the pending queue for
            ``engine.group_key(name, x)`` — (shape class, feature
            width, weight shapes). Only same-key requests ever share a
            dispatch; if the graph's class is retired by the lifecycle
            mid-flight, `drain_class` flushes the old key first, so the
            future still resolves.

        Thread-safe. Callers block only for the admission checks —
        except while a lifecycle retirement barrier (`drain_class`)
        holds the queue lock, during which submits wait for the
        retiring class's flush to finish dispatching.
        """
        key = self._group_key(name, x)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        with self._lock:
            now = self.clock()
            pol = self.admission
            if self._stopping:
                # after stop() no worker will ever dispatch this; admit
                # nothing rather than strand a future until its timeout
                self.stats.on_reject("stopped")
                self._trace_reject(name, "stopped")
                raise AdmissionError("stopped", "queue worker stopped")
            depth = self.scheduler.depth()
            bo = self.brownout
            if bo is not None and bo.observe(depth, now) \
                    and not guaranteed:
                # sustained overload: shed best-effort load at the door
                # (deterministic — every submit observes the same depth
                # state in submit order); guaranteed traffic proceeds to
                # the ordinary budget checks below
                self.stats.on_reject("brownout")
                self.stats.on_shed()
                self._trace_reject(name, "brownout")
                raise AdmissionError(
                    "brownout",
                    f"overload brownout active (depth {depth} vs high "
                    f"watermark {bo.high_depth}); best-effort load shed")
            n_healthy = self._healthy_replicas()
            depth_cap = pol.effective_depth(n_healthy)
            if depth_cap is not None and depth >= depth_cap:
                self.stats.on_reject("depth")
                self._trace_reject(name, "depth")
                raise AdmissionError(
                    "depth", f"queue depth {depth} >= {depth_cap}")
            if pol.max_wait_ms is not None:
                wait_s = self.scheduler.estimated_wait_s(key, now)
                if n_healthy > 1:
                    # the scheduler backlog drains across every healthy
                    # replica in parallel (the router spreads closed
                    # plans), so the wait a request actually faces is
                    # the fleet-divided estimate ...
                    wait_s /= n_healthy
                if self.pipeline is not None:
                    # ... plus work the pipeline already owns (queued
                    # plans + the bounded in-flight window), which the
                    # scheduler can't see. A ReplicaSet reports the
                    # min-over-replicas backlog here: the router will
                    # place this request's batch on that lane.
                    wait_s += self.pipeline.backlog_s()
                if wait_s * 1e3 > pol.max_wait_ms:
                    self.stats.on_reject("wait")
                    self._trace_reject(name, "wait")
                    raise AdmissionError(
                        "wait", f"estimated wait {wait_s * 1e3:.1f}ms > "
                                f"{pol.max_wait_ms}ms")
            fut = RequestFuture()
            self.stats.on_arrival(now)
            req = self.scheduler.add(name, x, key, now,
                                     deadline_s=now + deadline_ms / 1e3,
                                     future=fut, guaranteed=guaranteed)
            tr = self.tracer
            if tr.sample(req.seq):
                req.span_request = tr.begin(
                    "request", "request", req=req.seq,
                    args={"name": name, "deadline_ms": deadline_ms})
                req.span_queue = tr.begin(
                    "queue", "queue", req=req.seq,
                    parent=req.span_request)
            self._wake.notify_all()
        return fut

    def _healthy_replicas(self) -> int:
        """Healthy replica count (1 for single-device queues) — the
        admission capacity multiplier."""
        if self.replica_set is None:
            return 1
        return max(1, self.replica_set.healthy_count())

    def _trace_reject(self, name: str, reason: str) -> None:
        """A rejected submission still yields a (trivially closed)
        request span tree, tagged with a synthetic negative id — the
        trace-completeness property covers rejects too."""
        tr = self.tracer
        if tr.enabled:
            sid = tr.begin("request", "request", req=tr.reject_id(),
                           args={"name": name, "rejected": reason})
            tr.end(sid)

    def _trace_plans(self, plans) -> None:
        """Close members' queue spans when their batch plan closes —
        the one place every dispatch path (pump, drain, retirement
        barrier) funnels through, so queue wait is measured identically
        in serial and pipelined mode."""
        tr = self.tracer
        if not tr.enabled:
            return
        for plan in plans:
            for r in plan.members:
                if r.span_queue >= 0:
                    tr.end(r.span_queue, args={"reason": plan.reason})

    # -------------------------------------------------------- dispatch ----
    def _dispatch(self, plan) -> None:
        """Run one closed batch through the engine; resolve its futures.

        A failing dispatch resolves ITS members' futures with the error
        and is counted — it never propagates, so sibling plans from the
        same poll still dispatch and a threaded worker survives (a dead
        pump that keeps admitting traffic is the worst failure mode).

        Members are re-grouped by their **current** ``group_key`` at
        dispatch time, not the key the plan was closed under: a
        lifecycle retirement can land between ``poll`` (which pops the
        plan out of the scheduler, where `drain_class` can no longer
        see it) and this dispatch, re-classing members — possibly into
        *different* successor classes. Re-deriving keeps every
        sub-dispatch same-key by construction, so a stale plan degrades
        to an extra launch — never a mixed-key error or a stranded
        future.
        """
        with self._dispatch_gate:
            self._dispatch_plan(plan)

    def _dispatch_plan(self, plan) -> None:
        """Re-group a plan by current keys and dispatch each subgroup;
        caller holds the dispatch gate."""
        groups: dict = {}
        try:
            for r in plan.members:
                groups.setdefault(self.engine.group_key(r.name, r.x),
                                  []).append(r)
        except Exception as err:   # noqa: BLE001 — futures carry it
            self.stats.on_dispatch_error()
            tr = self.tracer
            for r in plan.members:
                if r.future is not None and not r.future.cancelled():
                    r.future.set_exception(err)
                if r.span_request >= 0:
                    tr.end(r.span_request, args={"error": True})
            return
        for key, members in groups.items():
            self._dispatch_group(key, members, plan.reason)

    def _dispatch_group(self, key, members, reason) -> None:
        """One same-key engine dispatch; caller holds the dispatch gate."""
        tr = self.tracer
        sp_batch = sp_dev = -1
        if tr.enabled and any(r.span_request >= 0 for r in members):
            sp_batch = tr.begin(
                "dispatch", "serving",
                args={"reqs": [r.seq for r in members], "reason": reason})
        misses0 = self.engine.executors.stats.misses  # benign race: cold-detect delta; over-reports only
        t0 = self.clock()
        try:
            pairs = [(r.name, r.x) for r in members]
            async_fn = getattr(self.engine, "serve_group_async", None)
            if async_fn is None:       # engine without the async surface
                outs, complete = self.engine.serve_group(pairs), None
            else:
                outs, meta = async_fn(pairs)
                complete = meta["complete"]
            # the serial device window: enqueue returned → results ready
            if sp_batch >= 0:
                sp_dev = tr.begin("device", "device", parent=sp_batch)
            # CUDA launches return before the card finishes: wait on the
            # dispatch's completion hook (its CUDA event), or dt would be
            # enqueue time and every latency/deadline number a lie.
            if complete is not None:
                complete()
        except Exception as err:   # noqa: BLE001 — futures carry it
            res = self._resilience
            if res is not None and res.handle_failure(
                    members, err, dispatch_fn=sync_dispatch_fn(self.engine),
                    latency=self.latency):
                # rescued inline (retry or quarantine resolved every
                # member); the batch span closes as rescued, not errored
                tr.end(sp_dev, args={"error": True})
                tr.end(sp_batch, args={"rescued": True})
                return
            self.stats.on_dispatch_error()
            tr.end(sp_dev, args={"error": True})
            tr.end(sp_batch, args={"error": True})
            for r in members:
                if r.future is not None and not r.future.cancelled():
                    r.future.set_exception(err)
                if r.span_request >= 0:
                    tr.end(r.span_request, args={"error": True})
            return
        dt = self.clock() - t0
        now = self.clock()
        padded = pow2_ceil(len(members))
        cold = self.engine.executors.stats.misses > misses0  # benign race: cold-detect delta; over-reports only
        res = self._resilience
        if res is not None and not outputs_finite(outs):
            # poisoned batch: quarantine bisection takes ownership of
            # every member; the poisoned sample never feeds the EWMA
            tr.end(sp_dev, args={"poisoned": True})
            self.latency.observe(key, padded, dt, cold=True)
            res.quarantine(members,
                           dispatch_fn=sync_dispatch_fn(self.engine))
            tr.end(sp_batch)
            return
        if sp_dev >= 0:
            tr.end(sp_dev, args={
                "reqs": [r.seq for r in members], "live": len(members),
                "padded": padded, "reason": reason, "cold": cold,
                "sclass": label(key[0])})
            if cold:
                tr.instant("compile_cold", "engine", parent=sp_batch)
        self.latency.observe(key, padded, dt, cold=cold)
        self.stats.on_batch(len(members), padded, reason)
        for r, y in zip(members, outs):
            if r.future is not None and not r.future.cancelled():
                r.future.set_result(y)
            self.stats.on_complete(now - r.submit_s,
                                   missed=now > r.deadline_s)
            if r.span_request >= 0:
                tr.end(r.span_request,
                       args={"missed": now > r.deadline_s})
        tr.end(sp_batch)

    def pump(self) -> int:
        """Close and dispatch every batch due now; returns batches run.

        Pipelined mode hands the closed plans to the `DispatchPipeline`
        (staging + non-blocking enqueue) and reaps any completions whose
        device results are already available — so a pump near capacity
        spends its time staging, not blocked on the device.
        """
        with self._lock:
            plans = self.scheduler.poll(self.clock())
            self._trace_plans(plans)
            # pipelined plans are ENROLLED inside the lock: a plan
            # popped out of the scheduler is the pipeline's
            # responsibility before the lock drops, so drain_class
            # (which quiesces the pipeline under this lock) can never
            # interleave its engine mutation with a popped-but-
            # untracked plan. The staging itself — which can block on
            # a full window — runs after the lock is released, so
            # submitters are never stalled behind device completions.
            if self.pipeline is not None:
                enrolled = [(self.pipeline.enroll(p), p) for p in plans]
        if self.pipeline is not None:
            for seq, plan in enrolled:
                self.pipeline.run_enrolled(seq, plan)
            self.pipeline.poll_completions()
            return len(plans)
        for plan in plans:
            self._dispatch(plan)
        return len(plans)

    def drain(self) -> int:
        """Rule (c): the caller declares the queue drained — close and
        dispatch everything still pending, then (pipelined mode) wait
        out the in-flight window so every future is resolved."""
        n = self.pump()
        with self._lock:
            plans = self.scheduler.flush()
            self._trace_plans(plans)
            if self.pipeline is not None:
                enrolled = [(self.pipeline.enroll(p), p) for p in plans]
        if self.pipeline is not None:
            for seq, plan in enrolled:
                self.pipeline.run_enrolled(seq, plan)
            self.pipeline.flush()
            return n + len(plans)
        for plan in plans:
            self._dispatch(plan)
        return n + len(plans)

    def inflight(self) -> int:
        """Batches the dispatch pipeline still owes (0 when serial)."""
        return 0 if self.pipeline is None else self.pipeline.depth()

    def drain_class(self, sclass, action=None) -> int:
        """Lifecycle barrier: flush every pending batch built on
        ``sclass``, then run ``action`` — all atomically with respect
        to ``submit``.

        The shape-class lifecycle retires a class by (1) dispatching
        every in-flight batch keyed on it through the OLD executors,
        then (2) mutating the engine (``action`` =
        ``Engine.execute_retirement``) so the class's members re-route
        to their successor class. Both steps happen under the queue
        lock, and the dispatch gate is awaited first, so:

          * no request is ever stranded on a key whose class stopped
            existing (flushed batches close with reason ``"retire"``);
          * a ``submit`` racing the retirement either lands before (and
            is flushed here, served by the old class) or after (and its
            ``group_key`` resolves to the successor class) — never in
            between;
          * a dispatch already running on the worker thread finishes on
            the old executors before the swap.

        Submissions block for the duration (a retirement is rare and
        its flush is small — at most one non-full batch per affected
        key). Returns the number of batches flushed.

        Pipelined mode: the flushed plans are submitted to the pipeline
        *behind* whatever is already queued/in flight (FIFO staging
        preserves per-key order), then ``pipeline.flush()`` quiesces the
        whole window — nothing queued, staging, enqueued, or completing
        — before ``action`` mutates the engine. That quiesce is the
        pipelined equivalent of the serial dispatch gate: no future can
        strand on the retired class's executors, and no batch can
        dispatch twice (plans leave the scheduler exactly once and the
        pipeline pops each exactly once).

        Multi-replica mode strengthens the same barrier: the
        `ReplicaSet` facade's ``flush`` quiesces EVERY replica's
        pipeline (drain-all-before-invalidate), so when ``action`` runs
        ``execute_retirement`` — which invalidates the class across all
        per-replica executor caches — no replica holds live work keyed
        on the retiring class.
        """
        with self._lock:
            plans = self.scheduler.close_matching(
                lambda key: key[0] == sclass)
            self._trace_plans(plans)
            if self.pipeline is not None:
                # quiesce FIRST: work the pipeline already owns —
                # including plans a pump thread enrolled but has not
                # staged yet — must enqueue before the barrier's own
                # flush plans, or a same-key batch could jump the
                # queue. New work can't arrive meanwhile: submits and
                # pump polls both need the lock held here.
                self.pipeline.flush()
                for plan in plans:
                    self.pipeline.submit(plan)
                self.pipeline.flush()   # the well-defined quiesce point
                if action is not None:
                    action()
                return len(plans)
            with self._dispatch_gate:   # waits out an in-flight dispatch
                for plan in plans:
                    self._dispatch_plan(plan)
                if action is not None:
                    action()
        return len(plans)

    def retirement_lull(self, sclass) -> bool:
        """True when no pending request keyed on ``sclass`` is close to
        its deadline (slack below ``safety_factor ×`` the batch's
        estimated dispatch latency). The lifecycle uses this to time its
        `drain_class` barrier: retiring during a lull lets urgent
        requests ride their natural deadline close through the old
        executors instead of being flushed into partial batches while
        submits are blocked."""
        with self._lock:
            return not self.scheduler.has_urgent(
                lambda key: key[0] == sclass, self.clock())

    def depth(self) -> int:
        with self._lock:
            return self.scheduler.depth()

    def next_due_s(self, now: float) -> Optional[float]:
        """Earliest instant a pump has work: the scheduler's next close,
        or (pipelined simulation) the in-flight window's next modeled
        completion — whichever comes first."""
        with self._lock:
            due = self.scheduler.next_due_s(now)
        if self.pipeline is not None:
            ready = self.pipeline.next_ready_s()
            if ready is not None:
                ready = max(ready, now)
                due = ready if due is None else min(due, ready)
        return due

    # -------------------------------------------------- threaded serving --
    def start(self) -> "RequestQueue":
        """Run the pump in a daemon worker until ``stop()``. Pipelined
        mode also starts the staging pool + completion drainer, so
        futures resolve the moment device results are ready."""
        if self._thread is not None:
            raise RuntimeError("worker already running")
        self._stopping = False
        if self.pipeline is not None:
            self.pipeline.start()
        self._thread = threading.Thread(
            target=self._worker, name="repro-serving-pump", daemon=True)
        self._thread.start()
        return self

    def _worker(self) -> None:
        while True:
            if self.pump():
                # more batches may already be closable (e.g. a burst
                # that size-filled several queues while we dispatched,
                # whose notifies fired with no waiter) — don't sleep
                # until a poll comes back empty
                continue
            with self._lock:
                if self._stopping:   # stop() drains synchronously after join
                    return
                due = self.scheduler.next_due_s(self.clock())
                if due is None:
                    self._wake.wait(timeout=0.1)
                else:
                    delay = due - self.clock()
                    if delay > 0:
                        self._wake.wait(timeout=delay)

    def stop(self, drain: bool = True) -> None:
        """Stop the worker; by default flush pending work first."""
        thread, self._thread = self._thread, None
        if thread is not None:
            with self._lock:
                self._stopping = True
                self._wake.notify_all()
            thread.join()
        if self.pipeline is not None:
            self.pipeline.stop()   # flushes, then falls back to inline
        if drain:
            self.drain()
