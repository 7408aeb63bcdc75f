"""Engine telemetry primitives (port of part of repro.obs)."""
from .metrics import Counter, MetricsRegistry

__all__ = ["Counter", "MetricsRegistry"]
