"""Observability: span tracing, typed metrics, Perfetto export.

Port of ``repro.obs``: the same modules and public names, in pure
Python.

``obs`` is the single home for the serving stack's telemetry plumbing:

- :mod:`repro_torch.obs.trace` — ring-buffered span tracer, lock-free on
  the hot path, with explicit parent ids so spans survive thread hops
  between the staging workers, the drainer, and the submit thread.
- :mod:`repro_torch.obs.metrics` — typed Counter/Gauge/Histogram registry
  backing ``ServerStats``, ``ExecutorCache`` telemetry and the
  ``Engine.stats()`` re-export, plus the one shared percentile helper.
- :mod:`repro_torch.obs.export` — Chrome-trace/Perfetto JSON export (one
  track per thread + a virtual "device window" track).
- :mod:`repro_torch.obs.report` — offline critical-path analysis over an
  exported trace.
"""
from repro_torch.obs.metrics import (Counter, CounterFamily, Gauge,
                                     GaugeFamily, Histogram, MetricsRegistry,
                                     percentile, percentile_ms)
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = [
    "Counter", "CounterFamily", "Gauge", "GaugeFamily", "Histogram",
    "MetricsRegistry", "percentile", "percentile_ms", "Tracer",
    "NULL_TRACER",
]
