"""Online EWMA latency model per executor key, split into pipeline
segments.

Port of ``repro.serving.latency``; pure Python.

The scheduler's deadline rule needs "how long would dispatching this
batch take?" *before* dispatching it. One exponentially-weighted moving
average per ``(group key, pow2 batch size)`` — the same granularity the
`ExecutorCache` builds executors at — answers that, learned purely from
observed warm dispatch wall times.

Since the dispatch path became pipelined, one dispatch has two
host-visible segments:

  staging — host-side batch prep: pad-to-class, stacking, executor
            lookup, and the (non-blocking) device enqueue. Ends when
            ``serve_group_async`` returns.
  device  — enqueue → results ready. Under pipelining this overlaps the
            *next* batch's staging; serially it is the tail of the same
            wall interval.

The model keeps one EWMA per segment plus the total; ``estimate``
returns the total (what the deadline rule budgets — a request must wait
for both segments), and ``estimate_segments`` exposes the split for the
admission/overlap accounting. Observations may carry the split
(``staging_s=..., device_s=...``) or just a total ``dt_s`` — the serial
dispatch path and old callers keep working unchanged.

Cold samples (a dispatch that built an executor) must NOT be folded into
ANY segment: the first dispatch of a key pays one-off host work inside
the call (in the process's first one, the nvcc build of every kernel
library), so a cold sample inflates the *staging* segment by orders of
magnitude, and first-touch device allocations pollute the device segment
too. The queue detects builds via the executor cache's miss counter
(serial path) or the ``cold`` flag in ``serve_group_async``'s completion
meta (pipelined path) and reports them with ``cold=True``; they are
counted but never averaged — per segment and per total alike.

Estimates for never-observed batch sizes fall back to the nearest
observed size for the same key — scaled linearly UP for larger batches
(group work is ~linear in the stacked axis) but NOT down for smaller
ones, where fixed launch overhead dominates and linear scaling would be
optimistic enough to close batches too late — then to the ``prior``
(e.g. `Engine.latency_prior`, a roofline FLOPs/bytes estimate for the
key's shape class), then to the flat ``default_s``. Seeding from the
prior means the very first deadline decisions for a fresh key are
informed by the class's arithmetic, not blind.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch.obs.metrics import Counter, MetricsRegistry


class LatencyModel:
    """EWMA of warm dispatch latency, keyed by (group key, batch size).

    >>> m = LatencyModel(alpha=0.5, default_s=0.05)
    >>> m.observe("k", 4, 0.1)
    >>> m.observe("k", 4, 30.0, cold=True)   # cold build: counted, not folded
    >>> m.estimate("k", 4)
    0.1
    >>> m.estimate("k", 8)                   # unseen size: scale UP only
    0.2
    >>> m.estimate("other", 4)               # unseen key: the default
    0.05
    >>> m.observe("k", 4, staging_s=0.03, device_s=0.07)
    >>> m.estimate_segments("k", 4)
    (0.03, 0.07)
    >>> round(m.estimate("k", 4), 3)         # total folds the split sum
    0.1
    """

    def __init__(self, alpha: float = 0.3, default_s: float = 0.05,
                 prior: Optional[Callable] = None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.default_s = default_s
        # prior(key, batch) -> Optional[float]: a model-based estimate
        # for keys never observed (None = no opinion, fall through to
        # default_s). Consulted only when no observation exists for the
        # key at any batch size — data always beats the prior.
        self.prior = prior
        self._ewma: dict = {}      # (key, batch) -> seconds, total
        self._staging: dict = {}   # (key, batch) -> seconds
        self._device: dict = {}    # (key, batch) -> seconds
        # Observation counters on the unified metrics backing store
        # (repro_torch.obs.metrics); legacy int reads stay available as
        # properties below.
        self.metrics = MetricsRegistry()
        self._observed = Counter("latency.observed", self.metrics)
        self._cold_skipped = Counter("latency.cold_skipped", self.metrics)
        self._prior_hits = Counter("latency.prior_hits", self.metrics)
        # Pipelined serving observes from the completion drainer while
        # submit/pump threads estimate — _nearest iterates the tables,
        # so unsynchronized inserts would raise mid-iteration.
        self._lock = threading.Lock()

    @property
    def observed(self) -> int:
        return self._observed.value

    @property
    def cold_skipped(self) -> int:
        return self._cold_skipped.value

    @property
    def prior_hits(self) -> int:
        return self._prior_hits.value

    def _fold(self, table: dict, k, dt_s: float) -> None:
        prev = table.get(k)
        table[k] = (dt_s if prev is None
                    else (1 - self.alpha) * prev + self.alpha * dt_s)

    def observe(self, key, batch: int, dt_s: Optional[float] = None,
                cold: bool = False, *, staging_s: Optional[float] = None,
                device_s: Optional[float] = None) -> None:
        """Fold one dispatch in; cold samples are only counted.

        Either ``dt_s`` (an unsplit total, the serial dispatch path) or
        the ``staging_s``/``device_s`` split (the pipelined path) — when
        the split is given, the total EWMA folds their sum so serial and
        pipelined observations stay comparable.
        """
        if cold:
            self._cold_skipped.inc()
            return
        k = (key, int(batch))
        with self._lock:
            self._observed.inc()
            if staging_s is not None:
                self._fold(self._staging, k, staging_s)
            if device_s is not None:
                self._fold(self._device, k, device_s)
            if dt_s is None:
                if staging_s is None and device_s is None:
                    raise ValueError(
                        "observe needs dt_s or a segment split")
                dt_s = (staging_s or 0.0) + (device_s or 0.0)
            self._fold(self._ewma, k, dt_s)

    def _nearest(self, table: dict, key, batch: int):
        """Nearest observed batch for the key; scale up, never down."""
        best = None
        for (k, b), v in table.items():
            if k != key:
                continue
            cand = (abs(b - batch), v * max(1.0, batch / b))
            if best is None or cand[0] < best[0]:
                best = cand
        return None if best is None else best[1]

    def estimate(self, key, batch: int) -> float:
        """Expected warm latency (both segments) of a ``batch``-sized
        dispatch of ``key``: observation > scaled observation > prior >
        ``default_s``."""
        batch = int(batch)
        with self._lock:
            exact = self._ewma.get((key, batch))
            if exact is None:
                exact = self._nearest(self._ewma, key, batch)
        if exact is not None:
            return exact
        if self.prior is not None:
            p = self.prior(key, batch)
            if p is not None:
                self._prior_hits.inc()
                return float(p)
        return self.default_s

    def estimate_segments(self, key, batch: int) -> tuple:
        """(staging_s, device_s) estimate. Keys observed only unsplit
        (or never) split the total estimate with a conservative default:
        all of it device time, since that is the segment pipelining can
        hide and overestimating it never closes batches late."""
        batch = int(batch)
        k = (key, batch)
        with self._lock:
            stage = self._staging.get(k)
            if stage is None:
                stage = self._nearest(self._staging, key, batch)
            dev = self._device.get(k)
            if dev is None:
                dev = self._nearest(self._device, key, batch)
        if stage is not None and dev is not None:
            return stage, dev
        total = self.estimate(key, batch)
        if stage is not None:
            return stage, max(total - stage, 0.0)
        if dev is not None:
            return max(total - dev, 0.0), dev
        return 0.0, total

    def known(self, key, batch: int) -> bool:
        return (key, int(batch)) in self._ewma

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._ewma), "observed": self.observed,
                    "cold_skipped": self.cold_skipped,
                    "split_entries": len(self._device),
                    "prior_hits": self.prior_hits}


class AggregateLatencyModel:
    """Read-only min-over-replicas view of per-replica latency models.

    Under a `ReplicaSet` every replica learns its own EWMAs (replicas
    may have speed skew, and one replica's compile must not pollute
    another's estimates), but the scheduler and admission control need
    ONE model answering "how fast can the fleet serve this key?". The
    fleet serves a batch as fast as its best replica, so every estimate
    is the minimum over the member models; each member applies its own
    observation > prior > default fallback before the min is taken.

    The aggregate is intentionally not observable: dispatch completions
    must be folded into the owning replica's model (the pipeline does
    this), never into the fleet view — ``observe`` raises to make
    accidental single-device-style wiring fail loudly.

    >>> a, b = LatencyModel(default_s=0.05), LatencyModel(default_s=0.05)
    >>> a.observe("k", 4, 0.08); b.observe("k", 4, 0.02)
    >>> agg = AggregateLatencyModel([a, b])
    >>> agg.estimate("k", 4)
    0.02
    >>> agg.known("k", 4)
    True
    """

    def __init__(self, models):
        if not models:
            raise ValueError("AggregateLatencyModel needs >= 1 model")
        self.models = list(models)
        self.default_s = self.models[0].default_s

    def observe(self, *args, **kwargs) -> None:
        raise TypeError(
            "AggregateLatencyModel is read-only: fold observations into "
            "the owning replica's own LatencyModel")

    def estimate(self, key, batch: int) -> float:
        return min(m.estimate(key, batch) for m in self.models)

    def estimate_segments(self, key, batch: int) -> tuple:
        return min((m.estimate_segments(key, batch) for m in self.models),
                   key=sum)

    def known(self, key, batch: int) -> bool:
        return any(m.known(key, batch) for m in self.models)

    def snapshot(self) -> dict:
        return {"replicas": len(self.models),
                "models": [m.snapshot() for m in self.models]}
