"""Pipelined dispatch: overlap host-side batch prep with device compute.

Port of ``repro.serving.pipeline``. The serial frontend dispatches a
closed batch end-to-end — pad, stack, enqueue, **block until the device
finishes** — before touching the next one, so host staging and device
compute strictly alternate and queue delay blows up as arrivals approach
the serial service rate. H-GCN's whole premise is heterogeneous units
working *simultaneously*; this module brings that overlap to the serving
stack by exploiting CUDA's asynchronous launches: enqueueing device work
returns output tensors whose kernels may still be running, so the host
can stage batch k+1 while the device computes batch k. The engine's
completion contract is a CUDA event recorded after the dispatch
(``ready`` polls it, ``complete`` waits on it). A host-to-device copy of
pageable memory on the default stream waits for the work queued before
it, so staging that copies request features overlaps little with the
batch in flight.

`DispatchPipeline` is the subsystem between the scheduler's closed
`BatchPlan`s and the resolved futures:

  pump ──▶ staging (worker pool: regroup by current key, pad-to-class,
           stack, executor lookup, non-blocking enqueue via
           ``Engine.serve_group_async``)
       ──▶ bounded in-flight window (``max_inflight`` enqueued batches)
       ──▶ completion drainer (blocks on readiness, records the device
           segment, resolves futures)

Two driving modes share all of that logic:

  inline    — no threads. ``submit`` stages immediately; completions are
              reaped opportunistically (``poll_completions``) and by the
              window bound. This is what the deterministic SimClock
              simulation and the synchronous replay loop drive — and on
              a real engine it already overlaps, because the *device*
              runs behind CUDA's asynchronous launches regardless of
              host threading. Inline completion times are reap times (the
              next pump), so the device-segment EWMA is an upper bound
              (conservative: batches close earlier, never later) and a
              deadline miss means the *resolved future* was late —
              which is when a pump-driven caller could first read it.
  threaded  — ``start()`` (called by ``RequestQueue.start``) spins up
              ``stage_workers`` staging threads plus one completion
              drainer, so futures resolve the moment results are ready
              instead of at the next pump.

Ordering contract: batches are enqueued to the device in plan-close
order (a turnstile serializes the enqueue step across staging workers;
per-member padding runs before the turnstile, in parallel). Because a
single device stream also completes in enqueue order, the completion
drainer processes the in-flight window FIFO — so *within* a group key,
dispatch order, completion order, and future-resolution order all equal
close order, bitwise-identical to serial dispatch. Across keys the
window lets later batches' staging overlap earlier batches' compute,
which is the entire point.

``flush()`` is the quiesce point the lifecycle's ``drain_class`` barrier
builds on: it returns only when no plan is queued, staging, enqueued, or
completing — after it, mutating the engine can strand nothing.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import queue as queue_mod
import threading
import time
from typing import Optional

from repro_torch.obs.trace import NULL_TRACER, label

from .resilience import WatchdogTimeout, outputs_finite, sync_dispatch_fn
from .scheduler import pow2_ceil


@dataclasses.dataclass
class InflightBatch:
    """One same-key batch enqueued to the device, not yet resolved."""

    key: tuple
    members: list              # PendingRequests, dispatch order
    reason: str                # the plan's close reason
    outs: list                 # unresolved device values, member order
    cold: bool                 # staging compiled an executor
    ready: object              # () -> bool, non-blocking
    complete: object           # () -> None, blocks until outs resolve
    staging_s: float           # host prep + enqueue wall time
    t_enqueued: float          # clock at enqueue return
    done_hint_s: Optional[float] = None   # modeled finish (simulation)
    span: int = -1             # device-window span id (-1 = untraced);
                               # begun at enqueue, ended by the drainer

    @property
    def padded(self) -> int:
        return pow2_ceil(len(self.members))


class DispatchPipeline:
    """Bounded-window pipelined dispatcher over ``serve_group_async``."""

    #: EWMA smoothing for the observed overlap ratio (adaptive window).
    OVERLAP_ALPHA = 0.2

    def __init__(self, engine, latency, stats, clock, *,
                 max_inflight: int = 4, stage_workers: int = 1,
                 adaptive_inflight: bool = False, tracer=None,
                 replica_id: int = -1):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if stage_workers < 1:
            raise ValueError(
                f"stage_workers must be >= 1, got {stage_workers}")
        self.engine = engine
        self.latency = latency
        self.stats = stats
        self.clock = clock
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # -1 = single-device pipeline; >= 0 labels this pipeline's device
        # spans, stats, and in-flight gauges with its replica in a
        # `ReplicaSet` (each replica owns exactly one pipeline).
        self.replica_id = replica_id
        # optional `(members, err) -> bool` hook consulted before member
        # futures carry a dispatch error; returning True means the
        # handler took ownership (the ReplicaSet's fault-requeue path).
        # Set post-construction, before any dispatch.
        self.fail_handler = None
        # failure-containment hooks, both installed (post-construction)
        # by a `ResilienceCoordinator`; None = zero-cost disabled path.
        # `watchdog` bounds time-in-device-window (a hang becomes a
        # retryable `WatchdogTimeout`); `resilience` owns poison-batch
        # quarantine of non-finite outputs.
        self.watchdog = None
        self.resilience = None
        # ``max_inflight`` is the LIVE window bound (what staging checks);
        # ``inflight_cap`` the configured ceiling. With adaptive_inflight
        # the live bound tracks the observed staging/device overlap: a
        # window that completes with no host wait (overlap ~1) earns its
        # full cap, one where completion always blocks (overlap ~0 — the
        # device is the bottleneck) shrinks toward 1 so queued batches
        # wait in the queue (visible to the scheduler's deadline math)
        # instead of invisibly inside the device window.
        self.max_inflight = max_inflight
        self.inflight_cap = max_inflight
        self.adaptive_inflight = adaptive_inflight
        self.overlap_ewma: Optional[float] = None
        self.stage_workers = stage_workers
        self._has_prepare = callable(getattr(engine, "prepare_x", None))
        # one lock, several conditions: _work (drainer wakeups), _room
        # (window-slot waiters), _idle (flush waiters)
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._room = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._inflight: collections.deque = collections.deque()
        self._completing = 0        # popped for completion, not finished
        self._completing_tids: collections.Counter = collections.Counter()
        self._queued: dict = {}     # seq -> (key, padded) awaiting staging
        self._staging = 0           # plans inside a worker right now
        self._seq = itertools.count()
        # threaded mode state
        self._plan_q: Optional[queue_mod.Queue] = None
        self._threads: list = []
        self._drainer: Optional[threading.Thread] = None
        self._stop = False
        self._turn = 0              # next seq allowed through the enqueue
        self._turn_cv = threading.Condition(self._lock)

    # ------------------------------------------------------------ intake ----
    def enroll(self, plan) -> int:
        """Make one closed `BatchPlan` the pipeline's responsibility and
        return its sequence ticket (-1 when the staging pool took it).

        This is the cheap half of `submit`, safe to call while holding
        the frontend's queue lock: the plan becomes visible to
        ``flush``/``depth``/``backlog_s`` immediately — so a concurrent
        ``drain_class`` can never observe a popped-but-untracked plan —
        while the (potentially blocking) staging happens later via
        `run_enrolled`, outside that lock. Seq assignment and handoff
        are one atomic step: were they split, two racing submitters
        could invert seq order in the plan queue and park a staging
        worker at the turnstile forever (waiting on a turn that sits
        behind it).
        """
        with self._lock:
            seq = next(self._seq)
            self._queued[seq] = (plan.key, plan.padded)
            if self._plan_q is not None:
                self._plan_q.put((seq, plan))
                return -1
            return seq

    def run_enrolled(self, seq: int, plan) -> None:
        """Inline half of `submit`: stage + enqueue an enrolled plan
        (no-op for plans the staging pool took). May block completing
        the window's oldest batch — call WITHOUT the queue lock so a
        full window back-pressures staging, not the submitters."""
        if seq < 0:
            return
        self._stage_plan(seq, plan)
        self.poll_completions()

    def submit(self, plan) -> None:
        """Accept one closed `BatchPlan` (enroll + run in one call).

        Inline mode stages + enqueues now, enforcing the window by
        completing the oldest in-flight batch(es); threaded mode hands
        the plan to the staging pool and returns immediately.
        """
        self.run_enrolled(self.enroll(plan), plan)

    # ----------------------------------------------------------- staging ----
    def _regroup(self, plan):
        """Split a plan by each member's CURRENT group key (a lifecycle
        retirement can re-class members between close and staging —
        same contract as the serial dispatcher: a stale plan degrades to
        an extra dispatch, never a mixed-key error)."""
        groups: dict = {}
        for r in plan.members:
            groups.setdefault(self.engine.group_key(r.name, r.x),
                              []).append(r)
        return groups

    def _fail(self, members, err: Exception) -> None:
        handler = self.fail_handler
        if handler is not None and handler(members, err):
            return                     # requeued elsewhere, futures live
        self.stats.on_dispatch_error()
        tr = self.tracer
        for r in members:
            if r.future is not None and not r.future.cancelled():
                r.future.set_exception(err)
            if r.span_request >= 0:
                tr.end(r.span_request, args={"error": True})

    def _stage_plan(self, seq: int, plan) -> None:
        """Regroup + prepare + enqueue one plan (caller owns ordering)."""
        with self._lock:
            self._queued.pop(seq, None)
            self._staging += 1
        tr = self.tracer
        sp_stage = -1
        if tr.enabled and any(r.span_request >= 0 for r in plan.members):
            sp_stage = tr.begin(
                "staging", "serving",
                args={"reqs": [r.seq for r in plan.members]})
        try:
            try:
                groups = self._regroup(plan)
                prepared = self._prepare(groups) if self._has_prepare \
                    else {}
            except Exception as err:   # noqa: BLE001 — futures carry it
                self._fail(plan.members, err)
                return
            for key, members in groups.items():
                # window bound: a full window completes its oldest batch
                # (a host-side wait — exactly the backpressure that
                # keeps device memory and queue-delay exposure bounded)
                # BEFORE the next enqueue, never after
                while self.depth_inflight() >= self.max_inflight:  # benign race: single-int window bound; any published value is in [1, cap]
                    self._drain_one(block=True)
                self._enqueue_group(key, members, plan.reason,
                                    prepared.get(key), span_parent=sp_stage)
        finally:
            tr.end(sp_stage)
            with self._lock:
                self._staging -= 1
                # keep the enqueue turnstile in step even inline, so a
                # later start() never waits on a seq that already ran
                self._turn = seq + 1
                self._turn_cv.notify_all()
                self._idle.notify_all()

    def _prepare(self, groups) -> dict:
        """Per-member feature staging (pad-to-class + device placement):
        the shared-state-free part of prep, safe to run before the
        ordered enqueue step — this is what multiple staging workers
        parallelize."""
        return {key: [self.engine.prepare_x(r.name, r.x) for r in members]
                for key, members in groups.items()}

    def _enqueue_group(self, key, members, reason, prepared, *,
                       span_parent: int = -1) -> None:
        """One non-blocking same-key engine dispatch -> in-flight entry."""
        t0 = self.clock()
        try:
            async_fn = getattr(self.engine, "serve_group_async", None)
            reqs = [(r.name, r.x) for r in members]
            if async_fn is not None:
                if prepared is not None:
                    outs, meta = async_fn(reqs, prepared)
                else:
                    outs, meta = async_fn(reqs)
            else:                      # engine without the async surface
                outs = self.engine.serve_group(reqs)
                meta = {"cold": False, "ready": lambda: True,
                        "complete": lambda: None}
        except Exception as err:   # noqa: BLE001 — futures carry it
            # A dispatch-time failure must NOT fail (or rescue) its
            # members here: earlier same-key batches may still be in the
            # window, and resolving these members first would break the
            # per-key ordering contract. Park the failure as an already-
            # ready in-flight batch whose completion re-raises — it
            # surfaces in `_finish` at its FIFO slot, where the failure
            # path (and any resilience retry) is order-safe.
            now = self.clock()

            def _reraise(e=err):
                raise e

            batch = InflightBatch(
                key=key, members=members, reason=reason, outs=[],
                cold=False, ready=lambda: True, complete=_reraise,
                staging_s=now - t0, t_enqueued=now)
            with self._lock:
                self._inflight.append(batch)
                self._work.notify_all()
            return
        now = self.clock()
        batch = InflightBatch(
            key=key, members=members, reason=reason, outs=outs,
            cold=bool(meta.get("cold")), ready=meta["ready"],
            complete=meta["complete"], staging_s=now - t0, t_enqueued=now,
            done_hint_s=meta.get("done_s"))
        tr = self.tracer
        if tr.enabled and any(r.span_request >= 0 for r in members):
            # the device window opens HERE (enqueue returned); it closes
            # on whichever thread drains the batch — explicit span id.
            # The replica label (when >= 0) is what routes the span onto
            # its own per-replica device track in the Chrome export.
            span_args = {"reqs": [r.seq for r in members]}
            if self.replica_id >= 0:
                span_args["replica"] = self.replica_id
            batch.span = tr.begin(
                "device", "device", parent=span_parent, args=span_args)
        with self._lock:
            self._inflight.append(batch)
            self._work.notify_all()
        self.stats.on_inflight(self.depth_inflight(),
                               replica=self.replica_id)

    # -------------------------------------------------------- completion ----
    def _drain_one(self, block: bool) -> bool:
        """Complete the OLDEST in-flight batch (FIFO — the device stream
        finishes in enqueue order, so waiting on the head never waits
        behind idle work). Returns False when nothing (ready) to drain."""
        with self._lock:
            if not self._inflight:
                return False
            head = self._inflight[0]
            if not block:
                try:
                    if not head.ready():
                        # a hung head past its watchdog deadline is
                        # drained anyway: _finish converts it into a
                        # retryable WatchdogTimeout instead of letting
                        # it hold the window slot forever
                        wd = self.watchdog
                        if wd is None or not wd.expired(head, self.clock()):
                            return False
                except Exception:      # noqa: BLE001 — resolve via finish
                    pass
            self._inflight.popleft()
            self._completing += 1
            tid = threading.get_ident()
            self._completing_tids[tid] += 1
        try:
            self._finish(head)
        finally:
            with self._lock:
                self._completing -= 1
                self._completing_tids[tid] -= 1
                if not self._completing_tids[tid]:
                    del self._completing_tids[tid]
                self._room.notify_all()
                self._idle.notify_all()
            self.stats.on_inflight(self.depth_inflight(),
                                   replica=self.replica_id)
        return True

    def _finish(self, batch: InflightBatch) -> None:
        """Block until the batch's device work is done; account the
        device segment; resolve the member futures."""
        tr = self.tracer
        sp_wait = -1
        if batch.span >= 0:
            # host blocked on the device window: trace_report recomputes
            # the overlap ratio from exactly these wait/device pairs
            sp_wait = tr.begin("wait_device", "drain", parent=batch.span)
        t0 = self.clock()
        err = None
        timed_out = False
        if self.watchdog is not None:
            timed_out, err = self._watch(batch)
        if not timed_out:
            try:
                batch.complete()
            except Exception as e:     # noqa: BLE001 — futures carry it
                err = e
        now = self.clock()
        if err is not None:
            tr.end(sp_wait, args={"error": True})
            tr.end(batch.span, args={"error": True})
            self._fail(batch.members, err)
            return
        wait_s = now - t0
        device_s = now - batch.t_enqueued
        tr.end(sp_wait)
        if batch.span >= 0:
            end_args = {
                "reqs": [r.seq for r in batch.members],
                "live": len(batch.members), "padded": batch.padded,
                "reason": batch.reason, "cold": batch.cold,
                "sclass": label(batch.key[0])}
            if self.replica_id >= 0:
                end_args["replica"] = self.replica_id
            tr.end(batch.span, args=end_args)
            if batch.cold:
                tr.instant("compile_cold", "engine", parent=batch.span)
        res = self.resilience
        if res is not None and not outputs_finite(batch.outs):
            # poisoned batch: quarantine bisection takes ownership of
            # every member (offenders fail with PoisonedRequest, the
            # rest resolve inline, preserving per-key order); the
            # poisoned sample never feeds the latency EWMA
            self.latency.observe(batch.key, batch.padded, cold=True,
                                 staging_s=batch.staging_s,
                                 device_s=device_s)
            res.quarantine(batch.members,
                           dispatch_fn=sync_dispatch_fn(self.engine))
            return
        if self.adaptive_inflight and device_s > 0:
            self._observe_overlap(wait_s, device_s)
        self.latency.observe(batch.key, batch.padded, cold=batch.cold,
                             staging_s=batch.staging_s, device_s=device_s)
        self.stats.on_batch(len(batch.members), batch.padded, batch.reason)
        self.stats.on_pipeline(batch.staging_s, device_s, wait_s,
                               replica=self.replica_id)
        for r, y in zip(batch.members, batch.outs):
            if r.future is not None and not r.future.cancelled():
                r.future.set_result(y)
            self.stats.on_complete(now - r.submit_s,
                                   missed=now > r.deadline_s)
            if r.span_request >= 0:
                tr.end(r.span_request,
                       args={"missed": now > r.deadline_s})

    def _watch(self, batch: InflightBatch):
        """Wait for the batch's readiness under the watchdog deadline.

        Returns ``(timed_out, err)``. A batch still not ready at the
        deadline is abandoned: completion is never attempted (on a real
        device that would block forever), the fire is counted, and a
        retryable `WatchdogTimeout` is handed to the failure path so
        the members are re-dispatched instead of stranded. On a
        `SimClock` the wait advances virtual time; on a real clock it
        polls."""
        wd = self.watchdog
        deadline = wd.deadline_for(batch)
        advance = getattr(self.clock, "advance", None)
        while True:
            try:
                if batch.ready():
                    return False, None
            except Exception:          # noqa: BLE001 — complete() surfaces it
                return False, None
            now = self.clock()
            if now >= deadline:
                wd.record_fire()
                self.stats.on_watchdog_fire()
                if self.tracer.enabled:
                    self.tracer.instant(
                        "watchdog_fire", "resilience",
                        args={"reqs": [r.seq for r in batch.members],
                              "deadline_s": deadline})
                return True, WatchdogTimeout(batch.key, deadline, now)
            step = min(1e-3, deadline - now)
            if advance is not None:
                advance(step)
            else:
                time.sleep(step)

    def _observe_overlap(self, wait_s: float, device_s: float) -> None:
        """Fold one batch's staging/device overlap into the live window.

        ``wait_s / device_s`` is the fraction of the batch's device
        segment the completion path spent *blocked on the host* — work
        the window failed to hide. overlap = 1 - that, clamped to
        [0, 1], EWMA-smoothed, then mapped onto [1, inflight_cap]:

            effective = 1 + round(ewma * (cap - 1))

        The window bound is read unlocked by staging (a deliberately
        racy single-int read: any value it sees is a bound this method
        published, so the window is always in [1, cap])."""
        overlap = min(1.0, max(0.0, 1.0 - wait_s / device_s))
        with self._lock:
            ewma = self.overlap_ewma
            ewma = overlap if ewma is None else \
                (1 - self.OVERLAP_ALPHA) * ewma + self.OVERLAP_ALPHA * overlap
            self.overlap_ewma = ewma
            cap = self.inflight_cap
            self.max_inflight = max(
                1, min(cap, 1 + int(round(ewma * (cap - 1)))))
            self._room.notify_all()

    def poll_completions(self) -> int:
        """Inline-mode reaper: finish every in-flight batch whose device
        results are already available, without blocking. (In threaded
        mode the drainer makes this a no-op.)"""
        if self._drainer is not None:
            return 0
        n = 0
        while self._drain_one(block=False):
            n += 1
        return n

    def drain_inflight(self) -> int:
        """Complete (or fail) every batch currently in the in-flight
        window, blocking on each. The `ReplicaSet` fault path uses this
        to evict a dead replica's window in FIFO order — each batch
        raises at completion and lands in the failure handler — before
        requeueing, so rescued members keep their per-key order."""
        n = 0
        while self._drain_one(block=True):
            n += 1
        return n

    # ----------------------------------------------------------- windows ----
    def depth_inflight(self) -> int:
        """Batches enqueued to the device and not yet finished."""
        with self._lock:
            return len(self._inflight) + self._completing

    def depth_inflight_foreign(self) -> int:
        """Window work not owned by the calling thread: enqueued batches
        plus completions in progress on OTHER threads. The `ReplicaSet`
        eviction loop spins on this — the fault handler can run inside
        `_finish` (a completion-hook fault, or a dispatch failure parked
        into the window), so counting the caller's own in-progress
        completion would deadlock it against itself."""
        tid = threading.get_ident()
        with self._lock:
            own = self._completing_tids.get(tid, 0)
            return len(self._inflight) + self._completing - own

    def depth(self) -> int:
        """Everything the pipeline still owes: queued plans, plans being
        staged, enqueued batches, batches mid-completion."""
        with self._lock:
            return (len(self._queued) + self._staging
                    + len(self._inflight) + self._completing)

    def next_ready_s(self) -> Optional[float]:
        """Earliest modeled completion instant of the in-flight window,
        when the engine advertises one (the simulation's StubEngine
        does; a real device doesn't — its drainer resolves on actual
        readiness). Lets an event-driven replay wake up to reap a
        completion instead of waiting for the next arrival."""
        with self._lock:
            hints = [b.done_hint_s for b in self._inflight
                     if b.done_hint_s is not None]
        return min(hints) if hints else None

    def backlog_s(self) -> float:
        """Estimated service time of everything in the pipeline — the
        in-flight term of the admission wait (the scheduler only sees
        pending queues; without this a full window is invisible wait).

        Queued plans are charged a full dispatch; batches already
        enqueued to the device have paid their staging segment, so they
        are charged only the device segment (`estimate_segments`);
        batches mid-completion are nearly done and charged nothing.
        """
        with self._lock:
            queued = list(self._queued.values())
            inflight = [(b.key, b.padded) for b in self._inflight]
        return (sum(self.latency.estimate(k, p) for k, p in queued)
                + sum(self.latency.estimate_segments(k, p)[1]
                      for k, p in inflight))

    def flush(self) -> None:
        """Quiesce: return once nothing is queued, staging, enqueued, or
        completing. THE barrier `drain_class` builds on.

        The inline branch drains in-flight work itself, but still waits
        out all four counters — another thread may hold an enrolled
        plan it has yet to stage, or sit mid-`_finish` on a popped
        batch (``_completing``), and returning before either lands
        would let the caller mutate the engine under live work.
        """
        if self._plan_q is not None:
            with self._idle:
                while (self._queued or self._staging
                       or self._inflight or self._completing):
                    self._idle.wait(0.05)
            return
        while True:
            if self._drain_one(block=True):
                continue
            with self._idle:
                if not (self._queued or self._staging
                        or self._inflight or self._completing):
                    return
                self._idle.wait(0.01)

    # ---------------------------------------------------------- threading ---
    def start(self) -> "DispatchPipeline":
        """Switch to threaded mode: a staging pool + completion drainer."""
        if self._threads:
            raise RuntimeError("pipeline already started")
        self._stop = False
        self._plan_q = queue_mod.Queue()
        self._threads = [
            threading.Thread(target=self._stage_worker, daemon=True,
                             name=f"repro-stage-{i}")
            for i in range(self.stage_workers)]
        self._drainer = threading.Thread(target=self._drain_worker,
                                         daemon=True, name="repro-drain")
        for t in self._threads:
            t.start()
        self._drainer.start()
        return self

    def stop(self) -> None:
        """Flush, then stop the threads and fall back to inline mode."""
        if not self._threads:
            return
        self.flush()
        with self._lock:
            self._stop = True
            self._work.notify_all()
            self._turn_cv.notify_all()
        for _ in self._threads:
            self._plan_q.put(None)
        for t in self._threads:
            t.join()
        self._drainer.join()
        self._threads = []
        self._drainer = None
        self._plan_q = None

    def _stage_worker(self) -> None:
        while True:
            item = self._plan_q.get()
            if item is None:
                return
            seq, plan = item
            tr = self.tracer
            sp_stage = -1
            if tr.enabled and any(r.span_request >= 0
                                  for r in plan.members):
                sp_stage = tr.begin(
                    "staging", "serving",
                    args={"reqs": [r.seq for r in plan.members]})
            # parallel part: regroup + pad happen per-worker; the
            # enqueue-order turnstile below serializes device submission
            # in plan-close order so no key can ever reorder internally.
            try:
                groups = self._regroup(plan)
                prepared = self._prepare(groups) if self._has_prepare \
                    else {}
                err = None
            except Exception as e:     # noqa: BLE001 — futures carry it
                groups, prepared, err = {}, {}, e
            sp_turn = -1
            if sp_stage >= 0:
                sp_turn = tr.begin("turnstile", "serving",
                                   parent=sp_stage)
            with self._turn_cv:
                while self._turn != seq and not self._stop:
                    self._turn_cv.wait(0.05)
            tr.end(sp_turn)
            try:
                with self._lock:
                    self._queued.pop(seq, None)
                    self._staging += 1
                if err is not None:
                    self._fail(plan.members, err)
                else:
                    for key, members in groups.items():
                        with self._room:
                            while (len(self._inflight) + self._completing
                                   >= self.max_inflight
                                   and not self._stop):
                                self._room.wait(0.05)
                        self._enqueue_group(key, members, plan.reason,
                                            prepared.get(key),
                                            span_parent=sp_stage)
            finally:
                tr.end(sp_stage)
                with self._lock:
                    self._turn += 1
                    self._staging -= 1
                    self._turn_cv.notify_all()
                    self._idle.notify_all()

    def _drain_worker(self) -> None:
        while True:
            with self._lock:
                while not self._inflight and not self._stop:
                    self._work.wait(0.05)
                if self._stop and not self._inflight:
                    return
            self._drain_one(block=True)

    def snapshot(self) -> dict:
        with self._lock:
            return {"replica_id": self.replica_id,
                    "max_inflight": self.max_inflight,
                    "inflight_cap": self.inflight_cap,
                    "adaptive_inflight": self.adaptive_inflight,
                    "overlap_ewma": self.overlap_ewma,
                    # per-batch overlap sample distribution (the EWMA's
                    # input stream): what trace_report's span-measured
                    # ratio is compared against
                    "overlap_p50": self.stats.overlap_percentile(50),
                    "overlap_p90": self.stats.overlap_percentile(90),
                    "overlap_samples": self.stats.overlap_samples,
                    "stage_workers": self.stage_workers,
                    "threaded": bool(self._threads),
                    "queued_plans": len(self._queued),
                    "inflight": len(self._inflight) + self._completing}
