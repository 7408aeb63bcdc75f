"""Failure containment for the serving stack: retry, quarantine,
watchdog, brownout.

Port of ``repro.serving.resilience``. The `ReplicaSet` rescues exactly
one failure type (`ReplicaFault`). This module closes the rest of the
taxonomy (see docs/ROBUSTNESS.md):

- :class:`RetryPolicy` + :class:`ResilienceCoordinator` — transient
  dispatch/compile failures are retried inline with exponential backoff
  and seeded jitter.  Retries happen *at the failed batch's completion
  slot* (a synchronous re-dispatch), never by re-enqueueing to the
  pipeline tail: a later same-key batch may already be in flight behind
  the failed one, and the pipeline drains FIFO, so inline resolution is
  what preserves per-key order.  Retry latencies are observed with
  ``cold=True`` so they are excluded from the `LatencyModel` EWMA the
  same way compile-cold samples are.
- Poison-batch quarantine — a batch that produces non-finite outputs
  (or keeps raising under retry) is bisected: O(log n) synchronous
  re-dispatches isolate the offending member(s), which fail with a
  structured :class:`PoisonedRequest`; batch-mates resolve with outputs
  bitwise-equal to an unfaulted run (the re-dispatch computes the same
  function on the same inputs).
- :class:`DispatchWatchdog` — bounds time-in-device-window.  A batch
  whose device future never becomes ready (a hang) is converted into a
  retryable :class:`WatchdogTimeout` at ``deadline = t_enqueued +
  max(floor, factor x latency-model estimate)`` instead of occupying an
  in-flight slot forever.
- :class:`BrownoutController` — SLO-aware load shedding.  Under a
  sustained queue-depth breach, best-effort submissions are rejected
  deterministically (reason ``"brownout"``) while guaranteed traffic
  keeps serving; recovery requires the depth to stay under the low
  watermark for a hysteresis window.

Every recovery action increments an `obs` counter (``resilience.retries``,
``resilience.quarantined``, ``resilience.watchdog_fires``,
``resilience.shed``) and emits a trace instant, so ``trace_report``
shows what failed and what rescued it.  Nothing here runs unless a
coordinator is installed: the attribute checks on the hot path
(``pipeline.resilience is None``) keep the disabled cost to one read,
preserving the serial smoke's <=2% tracing-overhead gate.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.obs.trace import NULL_TRACER

from .scheduler import pow2_ceil


class PoisonedRequest(RuntimeError):
    """Structured failure for a request isolated by quarantine bisection."""

    def __init__(self, name: str, detail: str = ""):
        msg = f"request {name!r} quarantined: produced non-finite output"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
        self.name = name


class WatchdogTimeout(RuntimeError):
    """A dispatch exceeded its watchdog deadline. Transient: a fresh
    dispatch of the same members is expected to succeed."""

    transient = True

    def __init__(self, key, deadline_s: float, now_s: float):
        super().__init__(
            f"dispatch watchdog fired for key={key!r}: "
            f"deadline {deadline_s:.4f}s passed at {now_s:.4f}s")
        self.key = key
        self.deadline_s = deadline_s


def _is_transient(err: Exception) -> bool:
    return bool(getattr(err, "transient", False))


def outputs_finite(outs) -> bool:
    """True iff every float/complex output is fully finite.

    Tensors are checked where they lie (``torch.isfinite`` on the card
    for a CUDA tensor, which waits for the dispatch that produced it);
    anything else, such as the `StubEngine`'s numpy outputs, goes
    through numpy.

    >>> outputs_finite([np.ones(3), np.zeros(2)])
    True
    >>> outputs_finite([np.ones(3), np.array([1.0, np.nan])])
    False
    >>> outputs_finite([np.array([1, 2], dtype=np.int32)])  # ints pass
    True
    >>> outputs_finite([torch.tensor([1.0, float("inf")])])
    False
    """
    for y in outs:
        if isinstance(y, torch.Tensor):
            if ((y.is_floating_point() or y.is_complex())
                    and not bool(torch.isfinite(y).all())):
                return False
            continue
        a = np.asarray(y)
        if a.dtype.kind in "fc" and not bool(np.isfinite(a).all()):
            return False
    return True


def sync_dispatch_fn(engine):
    """A ``pairs -> outs`` closure that dispatches synchronously on
    ``engine`` (async surface when available, serial otherwise).  This
    is the primitive retry and bisection are built on: the re-dispatch
    resolves inline, at the failed batch's completion slot."""
    def dispatch(pairs):
        async_fn = getattr(engine, "serve_group_async", None)
        if async_fn is None:
            return engine.serve_group(pairs)
        outs, meta = async_fn(pairs)
        complete = meta.get("complete") if hasattr(meta, "get") else None
        if complete is not None:
            complete()
        return outs
    return dispatch


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff + seeded jitter.

    The jitter stream is keyed on ``(seed, token, attempt)`` so a given
    request's backoff schedule is reproducible run-to-run while distinct
    requests decorrelate.

    >>> p = RetryPolicy(max_attempts=3, backoff_base_s=0.001)
    >>> p.backoff_s(1, token=5) == p.backoff_s(1, token=5)
    True
    >>> p.backoff_s(3, token=5) > p.backoff_s(1, token=5)
    True
    """

    max_attempts: int = 3
    backoff_base_s: float = 1e-3
    backoff_factor: float = 2.0
    jitter_frac: float = 0.25
    seed: int = 0

    def backoff_s(self, attempt: int, token: int = 0) -> float:
        """Delay before retry ``attempt`` (1-based) of work ``token``."""
        base = self.backoff_base_s * self.backoff_factor ** (attempt - 1)
        if self.jitter_frac <= 0:
            return base
        rng = np.random.default_rng((self.seed, token & 0x7FFFFFFF, attempt))
        return base * (1.0 + self.jitter_frac * (2.0 * rng.random() - 1.0))


class DispatchWatchdog:
    """Deadline math for the in-flight window: a batch not ready by
    ``t_enqueued + max(floor_s, factor x modeled service)`` is hung."""

    def __init__(self, latency, *, factor: float = 8.0,
                 floor_s: float = 0.05):
        self.latency = latency
        self.factor = factor
        self.floor_s = floor_s
        self._lock = threading.Lock()
        self._fires = 0

    def deadline_for(self, batch) -> float:
        base = 0.0
        try:
            staging_s, device_s = self.latency.estimate_segments(
                batch.key, batch.padded)
            base = staging_s + device_s
        except Exception:   # noqa: BLE001 — unknown key: fall to floor
            base = 0.0
        if not base and batch.done_hint_s is not None:
            base = max(0.0, batch.done_hint_s - batch.t_enqueued)
        return batch.t_enqueued + max(self.floor_s, self.factor * base)

    def expired(self, batch, now: float) -> bool:
        return now >= self.deadline_for(batch)

    def record_fire(self) -> None:
        with self._lock:
            self._fires += 1

    @property
    def fires(self) -> int:
        with self._lock:
            return self._fires


class BrownoutController:
    """Hysteretic overload detector driving brownout load shedding.

    Activates after the queue depth holds at/above ``high_depth`` for
    ``breach_s``; deactivates after it holds at/below ``low_depth`` for
    ``recover_s``.  While active, the frontend sheds best-effort
    submissions (deterministically, in submit order — each rejected at
    admission with reason ``"brownout"``) and guaranteed traffic keeps
    serving.

    >>> b = BrownoutController(high_depth=4, low_depth=1)
    >>> b.observe(5, now=0.0)    # instant trip: breach_s defaults to 0
    True
    >>> b.observe(3, now=1.0)    # above low watermark: still active
    True
    >>> b.observe(1, now=2.0)    # at low watermark: recovers
    False
    """

    def __init__(self, *, high_depth: int = 64,
                 low_depth: Optional[int] = None,
                 breach_s: float = 0.0, recover_s: float = 0.0):
        if low_depth is None:
            low_depth = max(0, high_depth // 2)
        if low_depth >= high_depth:
            raise ValueError(
                f"low_depth ({low_depth}) must be < high_depth ({high_depth})")
        self.high_depth = high_depth
        self.low_depth = low_depth
        self.breach_s = breach_s
        self.recover_s = recover_s
        self._lock = threading.Lock()
        self._active = False
        self._breach_since: Optional[float] = None
        self._clear_since: Optional[float] = None

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active

    def observe(self, depth: int, now: float) -> bool:
        """Fold one depth sample in; return whether brownout is active."""
        with self._lock:
            if not self._active:
                if depth >= self.high_depth:
                    if self._breach_since is None:
                        self._breach_since = now
                    if now - self._breach_since >= self.breach_s:
                        self._active = True
                        self._clear_since = None
                else:
                    self._breach_since = None
            else:
                if depth <= self.low_depth:
                    if self._clear_since is None:
                        self._clear_since = now
                    if now - self._clear_since >= self.recover_s:
                        self._active = False
                        self._breach_since = None
                else:
                    self._clear_since = None
            return self._active

    def snapshot(self) -> dict:
        with self._lock:
            return {"active": self._active,
                    "high_depth": self.high_depth,
                    "low_depth": self.low_depth}


class ResilienceCoordinator:
    """Installs and drives the recovery actions on a frontend.

    One coordinator serves a whole `RequestQueue` (every pipeline of a
    `ReplicaSet` shares it); its counters aggregate across replicas.
    The coordinator never holds its own lock across a dispatch — the
    lock only guards the rescued/failed tallies.
    """

    def __init__(self, *, stats, clock, retry: Optional[RetryPolicy] = None,
                 tracer=None, watchdog_factor: float = 8.0,
                 watchdog_floor_s: float = 0.05):
        self.stats = stats
        self.clock = clock
        self.retry = retry if retry is not None else RetryPolicy()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.watchdog_factor = watchdog_factor
        self.watchdog_floor_s = watchdog_floor_s
        self._lock = threading.Lock()
        self._rescued = 0
        self._poisoned = 0

    # -------------------------------------------------------- install ----
    def install(self, queue) -> "ResilienceCoordinator":
        """Wire this coordinator into a `RequestQueue`: wrap every
        pipeline's fail handler (after the ReplicaSet's, which keeps
        first claim on `ReplicaFault`), arm a watchdog per pipeline,
        and register for the serial dispatch path."""
        target = getattr(queue, "pipeline", None)
        pipes = []
        if target is not None:
            n = getattr(target, "n_replicas", None)
            if n is not None:               # ReplicaSet facade
                pipes = [target.replica(i).pipeline for i in range(n)]
            else:
                pipes = [target]
        for pipe in pipes:
            self.install_pipeline(pipe)
        queue._resilience = self
        return self

    def install_pipeline(self, pipeline) -> None:
        if self.watchdog_factor and self.watchdog_factor > 0:
            pipeline.watchdog = DispatchWatchdog(
                pipeline.latency, factor=self.watchdog_factor,
                floor_s=self.watchdog_floor_s)
        pipeline.resilience = self
        prior = pipeline.fail_handler
        dispatch = sync_dispatch_fn(pipeline.engine)
        latency = pipeline.latency

        def handler(members, err):
            if prior is not None and prior(members, err):
                return True
            return self.handle_failure(
                members, err, dispatch_fn=dispatch, latency=latency,
                prior=prior)

        pipeline.fail_handler = handler

    # ------------------------------------------------------- recovery ----
    def handle_failure(self, members, err, *, dispatch_fn,
                       latency=None, prior=None) -> bool:
        """Classify a failed dispatch; return True when every member
        future was taken care of (rescued or structurally failed)."""
        if not members:
            return False
        if _is_transient(err):
            return self._retry_members(members, err, dispatch_fn=dispatch_fn,
                                       latency=latency, prior=prior)
        return False    # permanent: default path fails members with `err`

    def _retry_members(self, members, err, *, dispatch_fn, latency,
                       prior) -> bool:
        pol = self.retry
        token = members[0].seq
        key = members[0].key
        tr = self.tracer
        for attempt in range(1, pol.max_attempts + 1):
            self._backoff(pol.backoff_s(attempt, token))
            self.stats.on_retry()
            if tr.enabled:
                tr.instant("resilience_retry", "resilience",
                           args={"attempt": attempt,
                                 "reqs": [m.seq for m in members]})
            t0 = self.clock()
            try:
                outs = dispatch_fn([(m.name, m.x) for m in members])
            except Exception as e:      # noqa: BLE001 — classified below
                if _is_transient(e):
                    continue            # next backoff step
                # a retry can surface a replica death: give the prior
                # handler (the ReplicaSet requeue path) first claim
                if prior is not None and prior(members, e):
                    return True
                return False
            # cold=True: rescue dispatches never feed the latency EWMA,
            # exactly like compile-cold samples
            if latency is not None:
                latency.observe(key, pow2_ceil(len(members)),
                                self.clock() - t0, cold=True)
            if not outputs_finite(outs):
                self.quarantine(members, dispatch_fn=dispatch_fn)
                return True
            self.resolve_members(members, outs)
            return True
        return False                    # retries exhausted: default fail

    # ----------------------------------------------------- quarantine ----
    def quarantine(self, members, *, dispatch_fn) -> None:
        """Bisect a poisoned batch: isolate the offending member(s) in
        O(log n) re-dispatches, fail exactly those with
        `PoisonedRequest`, resolve the rest bitwise-equal to an
        unfaulted run. Always takes ownership of every member."""
        if self.tracer.enabled:
            self.tracer.instant(
                "quarantine_bisect", "resilience",
                args={"reqs": [m.seq for m in members]})
        self._bisect(list(members), dispatch_fn)

    def _bisect(self, members, dispatch_fn) -> None:
        if len(members) == 1:
            ok, outs = self._probe(members, dispatch_fn)
            if ok:
                self.resolve_members(members, outs)
            else:
                self._quarantine_member(members[0])
            return
        mid = (len(members) + 1) // 2
        for half in (members[:mid], members[mid:]):
            ok, outs = self._probe(half, dispatch_fn)
            if ok:
                self.resolve_members(half, outs)
            else:
                self._bisect(half, dispatch_fn)

    def _probe(self, members, dispatch_fn):
        """One bisection step: re-dispatch a subset; transient faults
        injected *during* the probe are retried so an unlucky probe
        never convicts an innocent member."""
        pairs = [(m.name, m.x) for m in members]
        for _ in range(self.retry.max_attempts + 1):
            try:
                outs = dispatch_fn(pairs)
            except Exception as e:      # noqa: BLE001 — classified below
                if _is_transient(e):
                    continue
                return False, None
            return outputs_finite(outs), outs
        return False, None

    def _quarantine_member(self, m) -> None:
        err = PoisonedRequest(m.name)
        fut = m.future
        if fut is not None and not fut.cancelled() and not fut.done():
            fut.set_exception(err)
        self.stats.on_quarantined()
        tr = self.tracer
        if m.span_request >= 0:
            tr.end(m.span_request, args={"error": True, "poisoned": True})
        if tr.enabled:
            tr.instant("quarantined", "resilience",
                       args={"name": m.name, "seq": m.seq})
        with self._lock:
            self._poisoned += 1

    # -------------------------------------------------------- resolve ----
    def resolve_members(self, members, outs) -> None:
        """Resolve rescued members exactly as the pipeline would have:
        result + completion accounting + request-span close."""
        now = self.clock()
        tr = self.tracer
        for m, y in zip(members, outs):
            fut = m.future
            if fut is not None and not fut.cancelled() and not fut.done():
                fut.set_result(y)
            self.stats.on_complete(now - m.submit_s,
                                   missed=now > m.deadline_s)
            if m.span_request >= 0:
                tr.end(m.span_request,
                       args={"missed": now > m.deadline_s,
                             "rescued": True})
        with self._lock:
            self._rescued += len(members)

    def _backoff(self, delay_s: float) -> None:
        # SimClock runs advance virtual time; real clocks briefly sleep
        # (capped: backoff bounds retry pressure, not liveness)
        advance = getattr(self.clock, "advance", None)
        if advance is not None:
            advance(delay_s)
        else:
            time.sleep(min(delay_s, 0.05))

    def snapshot(self) -> dict:
        with self._lock:
            return {"rescued": self._rescued, "poisoned": self._poisoned,
                    "retry_max_attempts": self.retry.max_attempts,
                    "watchdog_factor": self.watchdog_factor}

    @property
    def rescued(self) -> int:
        with self._lock:
            return self._rescued
