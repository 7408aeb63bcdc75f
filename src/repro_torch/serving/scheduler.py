"""Deadline-aware batch-closing scheduler over per-group pending queues.

Port of ``repro.serving.scheduler``; pure Python. Requests accumulate in
FIFO deques keyed by the same tuple the engine groups on — ``(shape
class, f_in, weight shapes)`` — because only same-key requests can share
one group executor dispatch. A batch closes when any of:

  (a) **size** — the queue reaches ``target_batch`` (a power of two, so
      the closed batch needs no pow2 padding in the engine);
  (b) **deadline** — the *oldest* member's remaining slack falls below
      ``safety_factor ×`` the EWMA-estimated latency of dispatching the
      batch at its current (pow2-rounded) size: waiting any longer for
      more occupancy would start missing deadlines;
  (c) **drain** — ``flush()``: the caller declares no more arrivals are
      coming (end of a replay, server shutdown), so lingering buys
      nothing.

The scheduler is a pure data structure: no threads, no real clock, no
dispatching. ``poll(now)`` returns `BatchPlan`s and the caller (the
`RequestQueue`, the simulation, a test) owns time and execution — which
is what makes the deadline logic deterministically testable.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Optional


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n <= 1 maps to 1).

    >>> [pow2_ceil(n) for n in (0, 1, 3, 8, 9)]
    [1, 1, 4, 8, 16]
    """
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass
class PendingRequest:
    """One queued inference request (times are absolute clock seconds)."""

    seq: int
    name: str
    x: object
    key: tuple                 # (shape class, f_in, w_shapes)
    submit_s: float
    deadline_s: float          # absolute; submit_s + deadline_ms/1e3
    future: object = None
    # Trace span ids (repro_torch.obs.trace): -1 = untraced. The frontend
    # sets them at submit; explicit ids let the queue span close on the
    # pump thread and the request span close on the drainer, no
    # thread-local context needed.
    span_request: int = -1     # root: submit -> future resolution
    span_queue: int = -1       # child: submit -> batch-plan close
    # SLO class: guaranteed requests are exempt from brownout load
    # shedding (repro_torch.serving.resilience.BrownoutController).
    guaranteed: bool = False
    # dispatch attempts consumed by the resilience retry path
    attempts: int = 0

    def slack(self, now: float) -> float:
        return self.deadline_s - now


@dataclasses.dataclass
class BatchPlan:
    """A closed batch ready to dispatch: same-key members, FIFO order."""

    key: tuple
    members: list
    reason: str                # "size" | "deadline" | "drain"

    @property
    def padded(self) -> int:
        return pow2_ceil(len(self.members))


class Scheduler:
    """Accumulates pending requests per group key; decides batch closes."""

    def __init__(self, latency_model, *, target_batch: int = 8,
                 safety_factor: float = 2.0,
                 max_linger_s: Optional[float] = None):
        if target_batch < 1 or target_batch & (target_batch - 1):
            raise ValueError(
                f"target_batch must be a power of two, got {target_batch}")
        self.latency = latency_model
        self.target_batch = target_batch
        self.safety_factor = safety_factor
        self.max_linger_s = max_linger_s
        self._pending: dict = collections.OrderedDict()  # key -> deque
        self._seq = itertools.count()

    # ---------------------------------------------------------- intake ----
    def add(self, name: str, x, key: tuple, now: float, deadline_s: float,
            future=None, guaranteed: bool = False) -> PendingRequest:
        req = PendingRequest(seq=next(self._seq), name=name, x=x, key=key,
                             submit_s=now, deadline_s=deadline_s,
                             future=future, guaranteed=guaranteed)
        q = self._pending.get(key)
        if q is None:
            q = self._pending[key] = collections.deque()
        q.append(req)
        return req

    def depth(self, key: Optional[tuple] = None) -> int:
        if key is not None:
            q = self._pending.get(key)
            return len(q) if q is not None else 0
        return sum(len(q) for q in self._pending.values())

    # --------------------------------------------------------- closing ----
    def _close(self, key: tuple, n: int, reason: str) -> BatchPlan:
        q = self._pending[key]
        members = [q.popleft() for _ in range(n)]
        if not q:
            del self._pending[key]
        return BatchPlan(key=key, members=members, reason=reason)

    # Boundary tolerance: `poll(next_due_s(now))` must always fire the
    # close it forecast — with strict `<` and float round-off, a caller
    # that sleeps to exactly the due instant would spin forever.
    EPS_S = 1e-9

    def _slack_due(self, key: tuple, q, now: float) -> bool:
        """The deadline-close horizon test: is the queue's tightest
        member's slack at or below ``safety_factor ×`` the estimated
        dispatch latency? Shared by the close rule and ``has_urgent``
        so the two notions of "urgent" can never drift apart."""
        est = self.latency.estimate(key, pow2_ceil(len(q)))
        # FIFO order is arrival order, not deadline order — a later
        # arrival may carry the tightest deadline, so the close rule
        # keys off the MINIMUM deadline in the queue
        dl = min(r.deadline_s for r in q)
        return dl - now <= self.safety_factor * est + self.EPS_S

    def _deadline_due(self, key: tuple, q, now: float) -> bool:
        if self._slack_due(key, q, now):
            return True
        return (self.max_linger_s is not None
                and now - q[0].submit_s + self.EPS_S >= self.max_linger_s)

    def poll(self, now: float) -> list:
        """Close every batch due at ``now`` (rules a+b); FIFO per key."""
        plans = []
        for key in list(self._pending):
            while self.depth(key) >= self.target_batch:          # (a)
                plans.append(self._close(key, self.target_batch, "size"))
            q = self._pending.get(key)
            if q and self._deadline_due(key, q, now):             # (b)
                plans.append(self._close(key, len(q), "deadline"))
        return plans

    def flush(self) -> list:
        """Close everything still pending (rule c: the queue drained)."""
        return self.close_matching(lambda key: True, reason="drain")

    def close_matching(self, pred, reason: str = "retire") -> list:
        """Force-close every pending batch whose key satisfies ``pred``.

        The shape-class lifecycle uses this with ``pred = key built on
        the retiring class``: requests already queued under a key that
        is about to stop existing must dispatch through the OLD
        executors before those are invalidated, or they would strand
        (their stored key would never match a live class again). Full
        ``target_batch`` runs still close as ``"size"``; the remainder
        closes with ``reason``.
        """
        plans = []
        for key in [k for k in self._pending if pred(k)]:
            while self.depth(key) >= self.target_batch:
                plans.append(self._close(key, self.target_batch, "size"))
            if self.depth(key):
                plans.append(self._close(key, self.depth(key), reason))
        return plans

    def has_urgent(self, pred, now: float) -> bool:
        """True when any pending queue whose key satisfies ``pred`` is
        already inside its deadline-close horizon (`_slack_due` — the
        same test rule (b) closes on). The lifecycle's retirement
        timing reads this (via ``RequestQueue.retirement_lull``) to
        defer its drain barrier to a lull instead of flushing requests
        that were about to close naturally."""
        return any(self._slack_due(key, q, now)
                   for key, q in self._pending.items() if q and pred(key))

    # -------------------------------------------------------- forecast ----
    def next_due_s(self, now: float) -> Optional[float]:
        """Earliest future instant a deadline close (rule b) fires, or
        None when nothing is pending. Past-due queues return ``now``;
        the threaded pump sleeps until this instead of busy-polling."""
        due = None
        for key, q in self._pending.items():
            if len(q) >= self.target_batch:   # rule (a) is due NOW
                return now
            est = self.latency.estimate(key, pow2_ceil(len(q)))
            t = min(r.deadline_s for r in q) - self.safety_factor * est
            if self.max_linger_s is not None:
                t = min(t, q[0].submit_s + self.max_linger_s)
            due = t if due is None else min(due, t)
        return None if due is None else max(due, now)

    def estimated_wait_s(self, key: tuple, now: float) -> float:
        """Admission-control forecast: service backlog a request joining
        ``key`` now stands behind — the dispatch latency of every batch
        already pending across **all** keys, plus the batch the request
        itself joins. Batches dispatch serially in the pump thread, so a
        request's wait includes other keys' backlog, not just its own;
        counting only the joining key would let a flood on key A sail
        past the wait budget by submitting under key B. Lingering for
        occupancy is excluded: the scheduler always closes before the
        request's own deadline, so linger is deadline-bounded by
        construction; unbounded wait only comes from dispatch
        backlog."""
        total = 0.0
        for k, q in self._pending.items():
            depth = len(q) + (1 if k == key else 0)
            batches = -(-depth // self.target_batch)
            total += batches * self.latency.estimate(k, self.target_batch)
        if key not in self._pending:
            # the joining request opens a fresh queue: one more batch
            total += self.latency.estimate(key, self.target_batch)
        return total
