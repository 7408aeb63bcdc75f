"""Typed metrics: Counter / Gauge / Histogram / {Counter,Gauge}Family + registry.

Port of ``repro.obs.metrics``. This module is the single backing store
for serving and engine telemetry: ``ServerStats``, ``ExecutorCache``
cache counters, the engine's stack-cache counters and ``LatencyModel``'s
observation counters are all built on these primitives, and their
``snapshot()`` methods re-export metric values instead of ad-hoc ints
and dicts.

Thread-safety contract: every metric owns its own ``threading.Lock`` and
every mutation and read of its value happens under that lock. Metric
locks are leaves in the repo-wide lock order — a metric method never
calls back out into serving or engine code — so incrementing a counter
while holding ``RequestQueue._lock`` or ``ExecutorCache._lock`` is
deadlock-free by construction.

The module also hosts the ONE shared percentile helper:
linear-interpolation percentiles via ``np.percentile``, empty-safe.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

Number = Union[int, float]


def percentile(samples: Sequence[Number], q: Number) -> float:
    """Linear-interpolation percentile of ``samples`` (0 <= q <= 100).

    The repo-wide percentile: ``np.percentile`` with its default
    ``linear`` interpolation, pinned by a regression test so latency
    percentiles mean the same thing in ``ServerStats``, the simulation
    smokes, the benchmark drivers and ``trace_report``. Empty input
    returns 0.0 instead of raising — snapshot paths run before any
    sample lands.

    >>> percentile([], 99)
    0.0
    >>> percentile([1.0, 2.0, 3.0, 4.0], 50)
    2.5
    """
    if len(samples) == 0:
        return 0.0
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


def percentile_ms(samples_s: Sequence[Number], q: Number) -> float:
    """``percentile`` over second-valued samples, reported in ms."""
    return percentile(samples_s, q) * 1e3


class Counter:
    """Monotonic counter. ``inc`` and ``value`` are lock-protected."""

    kind = "counter"

    def __init__(self, name: str, registry: "Optional[MetricsRegistry]" = None):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0
        if registry is not None:
            registry.register(self)

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> Number:
        with self._lock:
            return self._v

    def snapshot_value(self) -> Number:
        return self.value


class Gauge:
    """Last-write-wins gauge with an optional running max (``set_max``)."""

    kind = "gauge"

    def __init__(self, name: str, registry: "Optional[MetricsRegistry]" = None):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0.0
        if registry is not None:
            registry.register(self)

    def set(self, v: Number) -> None:
        with self._lock:
            self._v = v

    def set_max(self, v: Number) -> None:
        with self._lock:
            if v > self._v:
                self._v = v

    def add(self, n: Number) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> Number:
        with self._lock:
            return self._v

    def snapshot_value(self) -> Number:
        return self.value


class Histogram:
    """Sliding-window histogram of raw samples.

    Keeps the most recent ``window`` observations (enough for smoke and
    steady-state percentiles while bounding memory on long runs) plus
    lifetime ``count``/``total``. Percentiles go through the shared
    :func:`percentile` helper so every surface interpolates identically.
    """

    kind = "histogram"

    def __init__(self, name: str, registry: "Optional[MetricsRegistry]" = None,
                 *, window: int = 8192):
        self.name = name
        self.window = int(window)
        self._lock = threading.Lock()
        self._samples: List[float] = []
        self._count = 0
        self._total = 0.0
        if registry is not None:
            registry.register(self)

    def observe(self, v: Number) -> None:
        with self._lock:
            self._count += 1
            self._total += v
            self._samples.append(float(v))
            if len(self._samples) > self.window:
                del self._samples[: len(self._samples) - self.window]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def total(self) -> float:
        with self._lock:
            return self._total

    def values(self) -> List[float]:
        with self._lock:
            return list(self._samples)

    def mean(self) -> float:
        with self._lock:
            if self._count == 0:
                return 0.0
            return self._total / self._count

    def percentile(self, q: Number) -> float:
        with self._lock:
            samples = list(self._samples)
        return percentile(samples, q)

    def snapshot_value(self) -> dict:
        with self._lock:
            samples = list(self._samples)
            count, total = self._count, self._total
        return {
            "count": count,
            "mean": (total / count) if count else 0.0,
            "p50": percentile(samples, 50),
            "p99": percentile(samples, 99),
        }


class CounterFamily:
    """A labeled counter: one logical metric, one count per label.

    Replaces the ad-hoc ``dict.get(k, 0) + 1`` counter dicts that used
    to live inline in ``ServerStats`` (``rejected``, ``batch_hist``,
    ``close_reasons``). The whole family shares one lock; ``as_dict``
    returns a coherent copy.
    """

    kind = "family"

    def __init__(self, name: str, registry: "Optional[MetricsRegistry]" = None):
        self.name = name
        self._lock = threading.Lock()
        self._v: Dict = {}
        if registry is not None:
            registry.register(self)

    def inc(self, label, n: Number = 1) -> None:
        with self._lock:
            self._v[label] = self._v.get(label, 0) + n

    def get(self, label, default: Number = 0) -> Number:
        with self._lock:
            return self._v.get(label, default)

    def total(self) -> Number:
        with self._lock:
            return sum(self._v.values())

    def as_dict(self) -> Dict:
        with self._lock:
            return dict(self._v)

    def snapshot_value(self) -> Dict:
        return self.as_dict()


class GaugeFamily:
    """A labeled gauge: one logical metric, one last-written value per
    label. The per-replica analogue of :class:`CounterFamily` — e.g.
    ``replicas.depth`` holds each replica's current pipeline depth under
    its ``replica_id`` label. The whole family shares one lock;
    ``as_dict`` returns a coherent copy.
    """

    kind = "family"

    def __init__(self, name: str, registry: "Optional[MetricsRegistry]" = None):
        self.name = name
        self._lock = threading.Lock()
        self._v: Dict = {}
        if registry is not None:
            registry.register(self)

    def set(self, label, value: Number) -> None:
        with self._lock:
            self._v[label] = value

    def set_max(self, label, value: Number) -> None:
        with self._lock:
            if value > self._v.get(label, value - 1):
                self._v[label] = value

    def get(self, label, default: Number = 0) -> Number:
        with self._lock:
            return self._v.get(label, default)

    def as_dict(self) -> Dict:
        with self._lock:
            return dict(self._v)

    def snapshot_value(self) -> Dict:
        return self.as_dict()


class MetricsRegistry:
    """Name → metric map with a race-free whole-registry ``snapshot``.

    The registry is a namespace + export surface: metrics register on
    construction, and ``snapshot()`` walks them outside the registry
    lock (each metric snapshots under its OWN lock), so a snapshot
    concurrent with hot-path increments is race-free without a global
    pause.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def register(self, metric) -> None:
        with self._lock:
            self._metrics[metric.name] = metric

    def counter(self, name: str) -> Counter:
        c = Counter(name)
        self.register(c)
        return c

    def gauge(self, name: str) -> Gauge:
        g = Gauge(name)
        self.register(g)
        return g

    def histogram(self, name: str, *, window: int = 8192) -> Histogram:
        h = Histogram(name, window=window)
        self.register(h)
        return h

    def family(self, name: str) -> CounterFamily:
        f = CounterFamily(name)
        self.register(f)
        return f

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot_value() for m in metrics}
