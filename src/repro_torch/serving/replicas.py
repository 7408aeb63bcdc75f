"""Multi-replica dispatch: a device-aware router over per-device pipelines.

Port of ``repro.serving.replicas``. H-GCN routes heterogeneous work to
heterogeneous execution resources; the queue, scheduler and pipeline
tell that story for ONE device. `ReplicaSet` is the scale-out layer:
one executor cache + `DispatchPipeline` per replica lane (the
`Engine.replica_view` lanes, which share the engine's device — several
lanes on one card are independent executor caches behind one CUDA
stream — or simulated `StubReplica` timelines), and a router
that places each closed `BatchPlan` on the least-loaded replica while
preserving the single-device pipeline's per-key ordering contract.

Routing
-------
A plan for an unpinned group key goes to the healthy replica with the
lowest ``(LatencyModel segment backlog, in-flight depth, replica_id)``
score — backlog is the replica's own model estimate of everything its
pipeline still owes (`DispatchPipeline.backlog_s`), depth breaks cold
ties, the id makes the choice deterministic.

**Key-epoch pinning** is the ordering mechanism: the first plan of a key
pins the key to its chosen replica and opens an *epoch*. While the
pinned replica still holds ANY unfinished work (``pipeline.depth() >
0``), every later plan for that key follows the pin — within one replica
the pipeline already guarantees close order == completion order ==
resolution order. Only when the pinned replica has fully quiesced (all
of the key's futures are necessarily resolved, since nothing outlives a
zero-depth pipeline) may the key migrate, closing the epoch and opening
the next one on whichever replica now scores best. Migration at a
quiesce boundary cannot reorder: everything from the old epoch resolved
strictly before anything from the new epoch was even enqueued.

Per-replica learning
--------------------
Each replica owns its own `LatencyModel` (speed skew and per-replica
cold builds must not pollute a shared EWMA) and its own executor stack —
`Engine.replica_view` shares the `ClassRegistry` and registered graphs
but gives each view a private `ExecutorCache`. The frontend-facing
`AggregateLatencyModel` answers scheduler/admission queries with the
min over replica models ("how fast can the fleet serve this?"), and
`backlog_s` reports the min over healthy replicas — the wait a request
would actually see, since the router sends it to the least-loaded one.

Fault handling
--------------
A replica whose dispatch or completion raises `ReplicaFault` is marked
unhealthy: its pins are dropped (forcing a new epoch elsewhere), its
remaining in-flight window is drained — every batch fails at completion
and re-enters the handler — and all rescued members are requeued, in
global submit order, grouped per key, onto surviving replicas. Members
whose futures already resolved are skipped (duplicate dispatch
suppressed); a member that faults twice, or faults with no survivors
left, carries the error on its future. Admission capacity shrinks with
the healthy count (`AdmissionPolicy.effective_depth`).

Lock order: ``RequestQueue._lock -> ReplicaSet._lock ->
DispatchPipeline._lock`` (routing happens under the queue lock during
``pump``; scoring reads pipeline depth/backlog under the router lock).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import torch

from repro_torch.obs.trace import NULL_TRACER

from .latency import AggregateLatencyModel, LatencyModel
from .pipeline import DispatchPipeline
from .scheduler import BatchPlan


class ReplicaFault(RuntimeError):
    """A replica's device died mid-window (raised by its fault schedule
    in simulation, or by a real device backend on loss). Dispatch errors
    of this type — and only this type — trigger the requeue path."""


@dataclasses.dataclass
class Replica:
    """One device's serving lane: engine view + latency model + pipeline."""

    replica_id: int
    engine: object                 # per-replica engine view
    latency: LatencyModel
    pipeline: DispatchPipeline
    healthy: bool = True


def _device_count() -> int:
    """Default replica count: one per visible CUDA device, at least one.

    Only a count: the lanes are ``Engine.replica_view`` views on the
    engine's own device, so a host without a card gets one lane and no
    work moves anywhere."""
    return max(1, torch.cuda.device_count())


class ReplicaSet:
    """Router + per-replica pipelines behind the `RequestQueue`.

    Implements the same driving surface as `DispatchPipeline` (enroll /
    run_enrolled / submit / flush / depth / backlog_s / next_ready_s /
    poll_completions / start / stop), so the frontend's pump, drain,
    drain-class barrier and event loop work unchanged — the facade just
    adds a routing decision in ``enroll``.
    """

    def __init__(self, engine, n_replicas: Optional[int] = None, *,
                 stats, clock, max_inflight: int = 4,
                 stage_workers: int = 1, adaptive_inflight: bool = False,
                 tracer=None):
        if n_replicas is None:
            n_replicas = _device_count()
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.engine = engine
        self.stats = stats
        self.clock = clock
        self.tracer = tracer if tracer is not None else NULL_TRACER
        view_fn = getattr(engine, "replica_view", None)
        prior = getattr(engine, "latency_prior", None)
        self._replicas: List[Replica] = []
        for i in range(n_replicas):
            view = view_fn(i) if view_fn is not None else engine
            lat = LatencyModel(prior=prior)
            pipe = DispatchPipeline(
                view, latency=lat, stats=stats, clock=clock,
                max_inflight=max_inflight, stage_workers=stage_workers,
                adaptive_inflight=adaptive_inflight, tracer=self.tracer,
                replica_id=i)
            pipe.fail_handler = self._handler_for(i)
            self._replicas.append(Replica(i, view, lat, pipe))
        #: min-over-replicas read view — what the scheduler/admission use
        self.latency = AggregateLatencyModel(
            [r.latency for r in self._replicas])
        # Router state. _pins maps group key -> replica_id while the key
        # is pinned; _epochs counts how many epochs each key has opened.
        # _rescued/_rescue_depth implement the reentrant fault rescue;
        # _requeued_seqs bounds every member to ONE requeue.
        self._lock = threading.RLock()
        self._pins: dict = {}
        self._epochs: dict = {}
        self._rescued: list = []
        self._rescue_depth = 0
        self._requeued_seqs: set = set()

    def _handler_for(self, replica_id: int):
        def handler(members, err) -> bool:
            return self._on_dispatch_failure(replica_id, members, err)
        return handler

    # ------------------------------------------------------------ router ----
    def _score(self, replica: Replica) -> tuple:
        """Least-loaded score: the replica's own latency-model estimate
        of its pipeline backlog, then in-flight depth, then id."""
        return (replica.pipeline.backlog_s(),
                replica.pipeline.depth_inflight(),
                replica.replica_id)

    def _route(self, key) -> Replica:
        """Pick the replica for one closed plan (caller holds _lock)."""
        rid = self._pins.get(key)
        if rid is not None:
            pinned = self._replicas[rid]
            if pinned.healthy and pinned.pipeline.depth() > 0:
                return pinned      # open epoch: order demands this lane
        healthy = [r for r in self._replicas if r.healthy]
        if not healthy:
            raise ReplicaFault("no healthy replicas left")
        best = min(healthy, key=self._score)
        if self._pins.get(key) != best.replica_id:
            self._pins[key] = best.replica_id
            self._epochs[key] = self._epochs.get(key, 0) + 1
            self.stats.on_key_epoch()
        return best

    def epoch_of(self, key) -> int:
        """How many routing epochs ``key`` has opened (0 = never seen)."""
        with self._lock:
            return self._epochs.get(key, 0)

    def pinned_replica(self, key) -> Optional[int]:
        with self._lock:
            return self._pins.get(key)

    # --------------------------------------- DispatchPipeline facade ----
    def enroll(self, plan) -> tuple:
        """Route one closed plan and enroll it on its replica; the
        returned token feeds `run_enrolled`. Route + enroll are one
        atomic step under the router lock so two plans for the same key
        can never enter their replica's pipeline out of close order."""
        with self._lock:
            replica = self._route(plan.key)
            self.stats.on_route(replica.replica_id)
            return (replica.replica_id, replica.pipeline.enroll(plan))

    def run_enrolled(self, token: tuple, plan) -> None:
        """Stage + enqueue an enrolled plan on its replica. May block on
        that replica's window — call WITHOUT the router/queue locks."""
        rid, seq = token
        self._replicas[rid].pipeline.run_enrolled(seq, plan)

    def submit(self, plan) -> None:
        self.run_enrolled(self.enroll(plan), plan)

    def poll_completions(self) -> int:
        return sum(r.pipeline.poll_completions() for r in self._replicas)

    def depth(self) -> int:
        return sum(r.pipeline.depth() for r in self._replicas)

    def depth_inflight(self) -> int:
        return sum(r.pipeline.depth_inflight() for r in self._replicas)

    def backlog_s(self) -> float:
        """Admission's in-flight wait term: min over HEALTHY replicas —
        the router will send the next plan to the least-loaded lane, so
        the fleet-level wait is the best lane's backlog, not the sum."""
        backlogs = [r.pipeline.backlog_s()
                    for r in self._replicas if r.healthy]
        return min(backlogs) if backlogs else 0.0

    def next_ready_s(self) -> Optional[float]:
        hints = [h for r in self._replicas
                 for h in [r.pipeline.next_ready_s()] if h is not None]
        return min(hints) if hints else None

    def healthy_count(self) -> int:
        return sum(1 for r in self._replicas if r.healthy)

    def replica(self, i: int) -> Replica:
        return self._replicas[i]

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    def flush(self) -> None:
        """Quiesce EVERY replica — the drain-class barrier. Loops
        because failing a dead replica's window requeues work onto
        survivors that may already have been flushed this round."""
        while True:
            for r in self._replicas:
                r.pipeline.flush()
            if all(r.pipeline.depth() == 0 for r in self._replicas):
                return

    def start(self) -> "ReplicaSet":
        for r in self._replicas:
            r.pipeline.start()
        return self

    def stop(self) -> None:
        for r in self._replicas:
            r.pipeline.stop()

    # ------------------------------------------------------- fault path ----
    def _on_dispatch_failure(self, rid: int, members, err) -> bool:
        """`DispatchPipeline.fail_handler`: rescue a dead replica's work.

        Returns True when this handler took ownership of ``members``
        (requeued or explicitly failed); False hands back to the
        pipeline's normal failure path (non-fault errors).
        """
        if not isinstance(err, ReplicaFault):
            return False
        replica = self._replicas[rid]
        with self._lock:
            if replica.healthy:
                replica.healthy = False
                self.stats.on_replica_fault()
                for key in [k for k, p in self._pins.items() if p == rid]:
                    del self._pins[key]   # next plan opens a new epoch
            self._rescued.extend(members)
            if self._rescue_depth > 0:
                return True        # outermost invocation requeues
            self._rescue_depth += 1
        try:
            # Evict the dead replica's remaining window FIRST: each
            # batch fails at completion and re-enters this handler, so
            # _rescued accumulates every stranded member; the global
            # seq sort below restores submit order before requeueing.
            # "foreign" depth: this handler can itself be running inside
            # a batch completion, which must not count as evictable.
            while replica.pipeline.depth_inflight_foreign() > 0:
                if not replica.pipeline.drain_inflight():
                    time.sleep(0.0005)   # another thread mid-completion
        finally:
            with self._lock:
                rescued, self._rescued = self._rescued, []
                self._rescue_depth -= 1
        self._requeue(rescued, err)
        return True

    def _requeue(self, rescued, err) -> None:
        """Requeue rescued members per key in submit order; suppress
        members already resolved; fail the unrescuable."""
        by_key: dict = {}
        unrescuable: list = []
        with self._lock:
            alive = any(r.healthy for r in self._replicas)
            for m in sorted(rescued, key=lambda m: m.seq):
                if m.future is not None and m.future.done():
                    self.stats.on_dup_suppressed()
                    continue
                if m.seq in self._requeued_seqs or not alive:
                    unrescuable.append(m)
                    continue
                self._requeued_seqs.add(m.seq)
                by_key.setdefault(m.key, []).append(m)
        for key, ms in by_key.items():
            self.stats.on_requeued(len(ms))
            self.submit(BatchPlan(key=key, members=ms, reason="requeue"))
        if unrescuable:
            self._fail_members(unrescuable, err)

    def _fail_members(self, members, err) -> None:
        """Terminal failure (mirrors the pipeline's un-handled path)."""
        self.stats.on_dispatch_error()
        tr = self.tracer
        for m in members:
            if m.future is not None and not m.future.cancelled():
                m.future.set_exception(err)
            if m.span_request >= 0:
                tr.end(m.span_request, args={"error": True})

    # --------------------------------------------------------- snapshot ----
    def snapshot(self) -> dict:
        with self._lock:
            pinned = len(self._pins)
            epochs = sum(self._epochs.values())
            requeued = len(self._requeued_seqs)
        return {"replicas": len(self._replicas),
                "healthy": self.healthy_count(),
                "pinned_keys": pinned,
                "key_epochs": epochs,
                "requeued_members": requeued,
                "per_replica": [r.pipeline.snapshot()
                                for r in self._replicas]}
