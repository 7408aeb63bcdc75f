"""Typed metrics for the port's engine telemetry.

Port of the part of ``repro.obs.metrics`` that the executor cache and
the engine use: ``Counter`` and ``MetricsRegistry``. Every metric owns
its own ``threading.Lock`` and every mutation and read of its value
happens under that lock; metric locks are leaves in the lock order (a
metric method never calls back out into engine code).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Union

Number = Union[int, float]


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


class MetricsRegistry:
    """Name → metric map with a race-free whole-registry ``snapshot``."""

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
