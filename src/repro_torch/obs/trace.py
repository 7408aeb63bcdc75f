"""Ring-buffered span tracer, lock-free on the hot path.

Port of ``repro.obs.trace``; pure Python.

Design constraints, in order:

1. **Zero allocation when off.** Every ``begin``/``end``/``instant``
   starts with a plain attribute check and returns the ``-1`` sentinel
   (or nothing) before touching any other state. Instrumented call
   sites hold span ids as ints and guard with ``sid >= 0``, so a
   disabled tracer costs one attribute load + compare per site.
2. **Lock-free when on.** The hot path takes no lock: slot indices and
   span ids come from ``itertools.count()`` (a single C-level ``next``,
   atomic under the GIL), and each event is one tuple stored into a
   preallocated ring slot — a single list item write, also atomic.
   Torn reads are impossible because a slot is replaced wholesale;
   concurrent writers can only race for *different* slots. The only
   lock (``Tracer._lock``) guards the cold export/clear path.
3. **Spans survive thread hops.** A span is identified by an explicit
   integer id returned from ``begin``; ``end(sid)`` may run on any
   thread (staging worker begins a device span, the drainer ends it).
   Parent links are explicit ids for the same reason — the tracer keeps
   no thread-local "current span" stack.

Event kinds: ``"B"`` (span begin), ``"E"`` (span end), ``"i"``
(instant). Ring wrap drops the OLDEST events; exporters detect wrap
from the monotone slot sequence and report it rather than emitting a
silently truncated "complete" trace.

Sampling is deterministic: request ``seq`` is sampled iff
``seq % sample_every == 0``, so traced runs are reproducible under
``SimClock`` and the overhead gate compares identical schedules.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, Optional

# Tuple layout of one ring slot (kept a tuple, not a dataclass: one
# allocation, immutable, wholesale-replaced on wrap).
# (order, kind, sid, parent, req, name, cat, ts, tid, args)
_ORDER, _KIND, _SID, _PARENT, _REQ, _NAME, _CAT, _TS, _TID, _ARGS = range(10)


class Tracer:
    """Span/instant recorder over a fixed-size ring of event slots.

    ``clock`` is injectable (``SimClock`` in tests, ``time.monotonic``
    in production — monotone by contract; wall time never touches span
    math). ``sample_every=n`` samples every n-th request; batch-level
    spans are emitted whenever at least one member is sampled.
    """

    def __init__(self, *, capacity: int = 1 << 16,
                 clock: Optional[Callable[[], float]] = None,
                 sample_every: int = 1, enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = bool(enabled)
        self.clock = clock if clock is not None else time.monotonic
        self.sample_every = max(1, int(sample_every))
        self.capacity = int(capacity)
        self._slots: List[Optional[tuple]] = [None] * self.capacity
        self._next = itertools.count()    # ring slot sequence
        self._ids = itertools.count(1)    # span id sequence (0 unused)
        self._rejects = itertools.count(1)  # synthetic req ids, negated
        self._lock = threading.Lock()     # export/clear only

    # -- hot path ---------------------------------------------------------

    def sample(self, seq: int) -> bool:
        """Whether request ``seq`` is traced (False when disabled)."""
        if not self.enabled:
            return False
        return seq % self.sample_every == 0

    def begin(self, name: str, cat: str = "", *, req: int = -1,
              parent: int = -1, args=None) -> int:
        """Open a span; returns its id, or -1 when tracing is off."""
        if not self.enabled:
            return -1
        sid = next(self._ids)
        i = next(self._next)
        self._slots[i % self.capacity] = (
            i, "B", sid, parent, req, name, cat, self.clock(),
            threading.get_ident(), args)
        return sid

    def end(self, sid: int, args=None) -> None:
        """Close span ``sid`` (no-op for the -1 sentinel); any thread."""
        if not self.enabled or sid < 0:
            return
        i = next(self._next)
        self._slots[i % self.capacity] = (
            i, "E", sid, -1, -1, None, None, self.clock(),
            threading.get_ident(), args)

    def instant(self, name: str, cat: str = "", *, req: int = -1,
                parent: int = -1, args=None) -> None:
        """Record a point event (lifecycle retire, cache hit, sweep...)."""
        if not self.enabled:
            return
        sid = next(self._ids)
        i = next(self._next)
        self._slots[i % self.capacity] = (
            i, "i", sid, parent, req, name, cat, self.clock(),
            threading.get_ident(), args)

    def reject_id(self) -> int:
        """A synthetic (negative) request id for rejected submissions,
        which never receive a scheduler ``seq``."""
        return -next(self._rejects)

    # -- cold path --------------------------------------------------------

    def events(self) -> List[dict]:
        """Recorded events in emission order, as dicts.

        Takes the export lock only to fence against ``clear``; slot
        reads tolerate concurrent hot-path writes (a slot is replaced
        wholesale, never mutated in place).
        """
        with self._lock:
            slots = [s for s in self._slots if s is not None]
        slots.sort(key=lambda s: s[_ORDER])
        return [
            {"order": s[_ORDER], "ph": s[_KIND], "sid": s[_SID],
             "parent": s[_PARENT], "req": s[_REQ], "name": s[_NAME],
             "cat": s[_CAT], "ts": s[_TS], "tid": s[_TID],
             "args": s[_ARGS]}
            for s in slots
        ]

    def wrapped(self) -> bool:
        """True if the ring has dropped events (total emitted > capacity)."""
        with self._lock:
            slots = [s for s in self._slots if s is not None]
        if not slots:
            return False
        return max(s[_ORDER] for s in slots) + 1 > self.capacity

    def clear(self) -> None:
        with self._lock:
            self._slots = [None] * self.capacity
            self._next = itertools.count()


def label(obj) -> str:
    """Short human label for span args: ``summary()`` when available
    (shape classes, engines), else ``str``. Never raises — span args
    must not be able to take down a dispatch."""
    s = getattr(obj, "summary", None)
    if callable(s):
        try:
            return str(s())
        except Exception:          # noqa: BLE001 — best-effort label
            pass
    return str(obj)


# Shared always-off tracer: instrumented classes default to this so the
# hot path stays one attribute check when no tracer is attached.
NULL_TRACER = Tracer(capacity=1, enabled=False)
