"""Serving-frontend telemetry (`ServerStats`) and the simulation clock.

Every number a capacity planner needs to size the frontend lives here:
arrival rate, batch-size histogram (occupancy), request latency
percentiles, deadline misses, and per-reason admission rejections. The
queue updates counters inline; ``snapshot()`` renders one JSON-able dict
that `Engine.stats()` surfaces as its ``serving`` block.

Port of ``repro.serving.stats``. `ServerStats` owns no ad-hoc ints or
dicts: every figure is backed by a typed metric from
:mod:`repro_torch.obs.metrics` (Counter/Gauge/Histogram/CounterFamily)
registered in ``self.metrics``, so the snapshot is race-free (each
metric guards its own state with its own lock) and
`docs/TELEMETRY.md` can point every stats key at its backing registry
metric. The legacy attribute surface (``stats.batches``,
``stats.close_reasons`` ...) is preserved as read-only properties.

`SimClock` is the injectable manual clock the deterministic scheduler
simulation and the tests run on — the production default is
``time.monotonic``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.metrics import (Counter, CounterFamily, Gauge,
                                     GaugeFamily, Histogram, MetricsRegistry,
                                     percentile_ms)

# Cap on retained per-request latency samples: percentiles come from the
# most recent window, so a long-lived server's stats dict stays bounded.
LATENCY_WINDOW = 8192


class SimClock:
    """Manual monotonic clock for deterministic scheduler simulation.

    >>> clock = SimClock()
    >>> clock.advance(1.5)
    1.5
    >>> clock()
    1.5
    """

    def __init__(self, t0: float = 0.0):
        self.now = float(t0)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"SimClock cannot go backwards (dt={dt})")
        self.now += dt
        return self.now


class ServerStats:
    """Counters for one serving frontend; all times in seconds.

    Key reference (every key is a view over a registry metric named in
    parentheses; interpretation guidance in ``docs/TELEMETRY.md``):

    ``arrivals`` (``serving.arrivals``)
        Requests **admitted** (rejections are not arrivals).
    ``completed`` (``serving.completed``)
        Futures resolved with a result; ``arrivals - completed`` is the
        queue's current in-flight depth plus cancelled requests.
    ``batches`` (``serving.batches``)
        Dispatches executed; ``completed / batches`` is occupancy.
    ``deadline_misses`` (``serving.deadline_misses``)
        Requests whose result resolved *after* their absolute deadline.
        Soft accounting: the late result is still delivered.
    ``dispatch_errors`` (``serving.dispatch_errors``)
        Batches whose engine dispatch raised; every member future of
        such a batch carries the exception.
    ``rejected`` (``serving.rejected``)
        {admission reason: count} — ``"depth"`` / ``"wait"`` /
        ``"stopped"`` (see `AdmissionPolicy`).
    ``batch_hist`` (``serving.batch_hist``)
        {live batch size: count of dispatched batches}.
    ``close_reasons`` (``serving.close_reasons``)
        {close rule: count} — ``"size"`` (pow2 target reached),
        ``"deadline"`` (slack ran out), ``"drain"`` (flush), and
        ``"retire"`` (flushed by a shape-class retirement barrier).
    ``padded_slots`` (``serving.padded_slots``)
        Total pow2-padded group slots dispatched;
        ``completed / padded_slots`` is pad occupancy.
    ``latency_s`` (``serving.latency_s``)
        Rolling window (most recent ``LATENCY_WINDOW`` samples) of
        per-request submit→resolve latencies feeding the percentiles.

    Pipelined-dispatch telemetry (all zero under serial dispatch):

    ``pipelined``
        Whether this frontend dispatches through a `DispatchPipeline`.
    ``inflight_depth`` / ``inflight_peak`` (``serving.inflight_*``)
        Current and peak device-side in-flight window occupancy
        (batches enqueued, results not yet resolved).
    ``staging_s`` / ``device_s`` (``serving.staging_s/device_s``)
        Rolling windows of per-batch host-staging and enqueue→ready
        wall times — the two pipeline segments.
    ``device_span_total_s`` / ``device_wait_total_s``
        Cumulative device-segment span vs the host time actually spent
        *blocked* waiting on it; their gap is compute the pipeline hid
        behind staging (see ``overlap_ratio``).
    ``overlap`` (``serving.overlap``)
        Per-batch overlap samples (``1 − blocked/span``), the
        distribution behind the pipeline's adaptive-window EWMA —
        ``trace_report`` cross-checks its span-measured ratio against
        this family.

    Multi-replica telemetry (``replicas.*``, populated only when the
    frontend dispatches through a `ReplicaSet`; surfaces in
    ``snapshot()["replicas"]``):

    ``replicas.depth`` / ``replicas.depth_peak``
        Per-replica pipeline depth (current / peak), labeled by
        ``replica_id``.
    ``replicas.batches`` / ``replicas.routed``
        Per-replica dispatched-batch and router-decision counts.
    ``replicas.device_span_s`` / ``replicas.device_wait_s``
        Per-replica cumulative device span vs blocked-wait time; their
        ratio is the per-replica overlap in the snapshot.
    ``replicas.faults`` / ``replicas.requeued`` /
    ``replicas.dup_suppressed`` / ``replicas.key_epochs``
        Fault-handling counters: replicas marked unhealthy, member
        requests requeued onto survivors, duplicate dispatches
        suppressed (future already resolved at requeue), and key→
        replica pin epochs opened by the router.

    >>> s = ServerStats()
    >>> s.on_arrival(0.0); s.on_batch(3, padded=4, reason="drain")
    >>> s.on_complete(0.25, missed=False)
    >>> s.batches, s.padded_slots, s.deadline_misses
    (1, 4, 0)
    """

    def __init__(self):
        self.metrics = MetricsRegistry()
        m = self.metrics
        self._arrivals = Counter("serving.arrivals", m)
        self._completed = Counter("serving.completed", m)
        self._batches = Counter("serving.batches", m)
        self._deadline_misses = Counter("serving.deadline_misses", m)
        self._dispatch_errors = Counter("serving.dispatch_errors", m)
        self._rejected = CounterFamily("serving.rejected", m)
        self._batch_hist = CounterFamily("serving.batch_hist", m)
        self._close_reasons = CounterFamily("serving.close_reasons", m)
        self._padded_slots = Counter("serving.padded_slots", m)
        self._first_arrival = Gauge("serving.first_arrival_s", m)
        self._last_arrival = Gauge("serving.last_arrival_s", m)
        self._latency = Histogram("serving.latency_s", m,
                                  window=LATENCY_WINDOW)
        # pipelined-dispatch segment telemetry
        self.pipelined = False
        self._inflight_depth = Gauge("serving.inflight_depth", m)
        self._inflight_peak = Gauge("serving.inflight_peak", m)
        self._staging = Histogram("serving.staging_s", m,
                                  window=LATENCY_WINDOW)
        self._device = Histogram("serving.device_s", m,
                                 window=LATENCY_WINDOW)
        self._device_span_total = Counter("serving.device_span_total_s", m)
        self._device_wait_total = Counter("serving.device_wait_total_s", m)
        self._overlap = Histogram("serving.overlap", m,
                                  window=LATENCY_WINDOW)
        # multi-replica telemetry (populated only under a ReplicaSet)
        self._replica_depth = GaugeFamily("replicas.depth", m)
        self._replica_depth_peak = GaugeFamily("replicas.depth_peak", m)
        self._replica_batches = CounterFamily("replicas.batches", m)
        self._replica_routed = CounterFamily("replicas.routed", m)
        self._replica_span = CounterFamily("replicas.device_span_s", m)
        self._replica_wait = CounterFamily("replicas.device_wait_s", m)
        self._replica_faults = Counter("replicas.faults", m)
        self._replica_requeued = Counter("replicas.requeued", m)
        self._replica_dups = Counter("replicas.dup_suppressed", m)
        self._key_epochs = Counter("replicas.key_epochs", m)
        # resilience telemetry (docs/ROBUSTNESS.md): recovery actions
        # taken by the chaos/resilience layer — always present (zero)
        # so snapshots stay shape-stable with resilience disabled
        self._res_retries = Counter("resilience.retries", m)
        self._res_quarantined = Counter("resilience.quarantined", m)
        self._res_watchdog = Counter("resilience.watchdog_fires", m)
        self._res_shed = Counter("resilience.shed", m)

    # ------------------------------------------------------------ hooks ----
    def on_arrival(self, now: float) -> None:
        if self._arrivals.value == 0:
            self._first_arrival.set(now)
        self._last_arrival.set(now)
        self._arrivals.inc()

    def on_reject(self, reason: str) -> None:
        self._rejected.inc(reason)

    def on_batch(self, size: int, padded: int, reason: str) -> None:
        self._batches.inc()
        self._padded_slots.inc(padded)
        self._batch_hist.inc(size)
        self._close_reasons.inc(reason)

    def on_complete(self, latency_s: float, missed: bool) -> None:
        self._completed.inc()
        if missed:
            self._deadline_misses.inc()
        self._latency.observe(latency_s)

    def on_dispatch_error(self) -> None:
        self._dispatch_errors.inc()

    def on_inflight(self, depth: int, replica: int = -1) -> None:
        """Gauge update from the dispatch pipeline's window. Under a
        `ReplicaSet` each pipeline reports its own depth under its
        ``replica_id`` label (the aggregate depth is their sum, computed
        at snapshot time)."""
        self._inflight_depth.set(depth)
        self._inflight_peak.set_max(depth)
        if replica >= 0:
            self._replica_depth.set(replica, depth)
            self._replica_depth_peak.set_max(replica, depth)

    def on_pipeline(self, staging_s: float, device_s: float,
                    wait_s: float, replica: int = -1) -> None:
        """One pipelined batch's segment record: host staging time,
        enqueue→ready device span, and the host time actually spent
        blocked on that span (the unhidden remainder)."""
        self._staging.observe(staging_s)
        self._device.observe(device_s)
        self._device_span_total.inc(device_s)
        self._device_wait_total.inc(min(wait_s, device_s))
        if device_s > 0:
            self._overlap.observe(
                min(1.0, max(0.0, 1.0 - wait_s / device_s)))
        if replica >= 0:
            self._replica_batches.inc(replica)
            self._replica_span.inc(replica, device_s)
            self._replica_wait.inc(replica, min(wait_s, device_s))

    # --------------------------------------------------- replica hooks ----
    def on_route(self, replica: int) -> None:
        """One router decision: a closed plan enrolled on ``replica``."""
        self._replica_routed.inc(replica)

    def on_key_epoch(self) -> None:
        """A group key (re)pinned to a replica — a new routing epoch."""
        self._key_epochs.inc()

    def on_replica_fault(self) -> None:
        """A replica raised from its fault schedule and was marked
        unhealthy by the router."""
        self._replica_faults.inc()

    def on_requeued(self, n: int = 1) -> None:
        """Member requests rescued from a dead replica's batch and
        requeued onto a surviving replica."""
        self._replica_requeued.inc(n)

    def on_dup_suppressed(self, n: int = 1) -> None:
        """Requeue skipped a member whose future had already resolved —
        a duplicate dispatch suppressed."""
        self._replica_dups.inc(n)

    # ------------------------------------------- resilience hooks ---------
    def on_retry(self) -> None:
        """One inline retry dispatch of a transiently failed batch."""
        self._res_retries.inc()

    def on_quarantined(self) -> None:
        """One member failed with `PoisonedRequest` by bisection."""
        self._res_quarantined.inc()

    def on_watchdog_fire(self) -> None:
        """One in-flight batch converted from a hang into a retryable
        `WatchdogTimeout` by the dispatch watchdog."""
        self._res_watchdog.inc()

    def on_shed(self, n: int = 1) -> None:
        """Best-effort submissions rejected by brownout load shedding."""
        self._res_shed.inc(n)

    # ------------------------------------------- legacy attribute views ----
    @property
    def arrivals(self) -> int:
        return self._arrivals.value

    @property
    def completed(self) -> int:
        return self._completed.value

    @property
    def batches(self) -> int:
        return self._batches.value

    @property
    def deadline_misses(self) -> int:
        return self._deadline_misses.value

    @property
    def dispatch_errors(self) -> int:
        return self._dispatch_errors.value

    @property
    def rejected(self) -> dict:
        return self._rejected.as_dict()

    @property
    def batch_hist(self) -> dict:
        return self._batch_hist.as_dict()

    @property
    def close_reasons(self) -> dict:
        return self._close_reasons.as_dict()

    @property
    def padded_slots(self) -> int:
        return self._padded_slots.value

    @property
    def first_arrival_s(self) -> float:
        return self._first_arrival.value

    @property
    def last_arrival_s(self) -> float:
        return self._last_arrival.value

    @property
    def latency_s(self) -> list:
        return self._latency.values()

    @property
    def inflight_depth(self) -> int:
        return self._inflight_depth.value

    @property
    def inflight_peak(self) -> int:
        return self._inflight_peak.value

    @property
    def staging_s(self) -> list:
        return self._staging.values()

    @property
    def device_s(self) -> list:
        return self._device.values()

    @property
    def device_span_total_s(self) -> float:
        return self._device_span_total.value

    @property
    def device_wait_total_s(self) -> float:
        return self._device_wait_total.value

    # --------------------------------------------------------- rollups ----
    @property
    def rejected_total(self) -> int:
        return self._rejected.total()

    @property
    def mean_batch(self) -> float:
        """Occupancy: served requests per dispatched batch."""
        return self.completed / self.batches if self.batches else 0.0

    @property
    def pad_occupancy(self) -> float:
        """Live members per pow2-padded group slot (1.0 = no pad waste)."""
        return self.completed / self.padded_slots if self.padded_slots else 0.0

    @property
    def overlap_ratio(self) -> float:
        """Fraction of device compute hidden behind host staging: 1 −
        blocked-wait / device-span. 0 under serial dispatch (the host
        waits out every device segment); approaching 1 means the
        completion path almost always finds results already ready."""
        span = self.device_span_total_s
        if span <= 0:
            return 0.0
        return 1.0 - self.device_wait_total_s / span

    def overlap_percentile(self, q: float) -> float:
        """Percentile of the per-batch overlap sample distribution."""
        return self._overlap.percentile(q)

    @property
    def overlap_samples(self) -> int:
        return self._overlap.count

    def arrival_rate_hz(self) -> float:
        span = self.last_arrival_s - self.first_arrival_s
        return (self.arrivals - 1) / span if span > 0 else 0.0

    def latency_percentile_ms(self, q: float) -> float:
        return self._latency.percentile(q) * 1e3

    def mean_latency_ms(self) -> float:
        """Mean submit→resolve latency over the rolling window — the
        queue-delay headline the pipeline benchmark compares on (service
        time is a near-constant floor; growth here is queue delay)."""
        window = self._latency.values()
        if not window:
            return 0.0
        return float(np.mean(np.asarray(window)) * 1e3)

    def replica_snapshot(self) -> dict:
        """Per-replica depth/overlap plus the aggregate latency
        percentiles (the global histogram pools every replica's
        completions, so its p50/p99 ARE the aggregate figures)."""
        depths = self._replica_depth.as_dict()
        peaks = self._replica_depth_peak.as_dict()
        batches = self._replica_batches.as_dict()
        routed = self._replica_routed.as_dict()
        spans = self._replica_span.as_dict()
        waits = self._replica_wait.as_dict()
        per = {}
        for rid in sorted(set(depths) | set(batches) | set(routed)):
            span = spans.get(rid, 0.0)
            per[rid] = {
                "depth": depths.get(rid, 0),
                "depth_peak": peaks.get(rid, 0),
                "batches": batches.get(rid, 0),
                "routed": routed.get(rid, 0),
                "device_span_s": span,
                "overlap_ratio":
                    (1.0 - waits.get(rid, 0.0) / span) if span > 0 else 0.0,
            }
        return {
            "count": len(per),
            "per_replica": per,
            "inflight_depth": sum(depths.values()),
            "p50_ms": self.latency_percentile_ms(50),
            "p99_ms": self.latency_percentile_ms(99),
            "faults": self._replica_faults.value,
            "requeued": self._replica_requeued.value,
            "dup_suppressed": self._replica_dups.value,
            "key_epochs": self._key_epochs.value,
        }

    def snapshot(self) -> dict:
        snap = {
            "arrivals": self.arrivals,
            "completed": self.completed,
            "rejected": self.rejected,
            "rejected_total": self.rejected_total,
            "batches": self.batches,
            "batch_hist": dict(sorted(self.batch_hist.items())),
            "mean_batch": self.mean_batch,
            "pad_occupancy": self.pad_occupancy,
            "close_reasons": self.close_reasons,
            "arrival_rate_hz": self.arrival_rate_hz(),
            "p50_ms": self.latency_percentile_ms(50),
            "p99_ms": self.latency_percentile_ms(99),
            "mean_latency_ms": self.mean_latency_ms(),
            "deadline_misses": self.deadline_misses,
            "dispatch_errors": self.dispatch_errors,
            "pipelined": self.pipelined,
            "inflight_depth": self.inflight_depth,
            "inflight_peak": self.inflight_peak,
            "staging_p50_ms": percentile_ms(self.staging_s, 50),
            "staging_p99_ms": percentile_ms(self.staging_s, 99),
            "device_p50_ms": percentile_ms(self.device_s, 50),
            "device_p99_ms": percentile_ms(self.device_s, 99),
            "overlap_ratio": self.overlap_ratio,
            "overlap_p50": self.overlap_percentile(50),
            "overlap_p90": self.overlap_percentile(90),
            "overlap_samples": self.overlap_samples,
            "resilience": {
                "retries": self._res_retries.value,
                "quarantined": self._res_quarantined.value,
                "watchdog_fires": self._res_watchdog.value,
                "shed": self._res_shed.value,
            },
        }
        # only multi-replica frontends grow the block: single-pipeline
        # snapshots stay byte-identical to the pre-replica format
        if self._replica_routed.as_dict() or self._replica_depth.as_dict():
            snap["replicas"] = self.replica_snapshot()
        return snap

    def summary(self) -> str:
        return (f"ServerStats arrivals={self.arrivals} "
                f"completed={self.completed} rejected={self.rejected_total} "
                f"batches={self.batches} mean_batch={self.mean_batch:.2f} "
                f"p50={self.latency_percentile_ms(50):.1f}ms "
                f"p99={self.latency_percentile_ms(99):.1f}ms "
                f"misses={self.deadline_misses}")
