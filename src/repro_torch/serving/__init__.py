"""Async serving frontend over the shape-class Engine.

Port of ``repro.serving``, with the same modules and public names. A
standing `RequestQueue` accepts ``submit(name, x, deadline_ms)`` and
returns futures; the `Scheduler` accumulates per-(shape class, f_in,
weight shapes) pending queues and closes a batch on pow2 target size,
deadline slack vs the EWMA `LatencyModel` estimate, or drain — then
dispatches through ``Engine.serve_group_async`` (one launch of each
kernel per layer for the whole group). Admission control sheds load
with a reason; `ServerStats` telemetry surfaces through
``Engine.stats()["serving"]``. `simulate` replays deterministic
synthetic traces on a `SimClock` over the `StubEngine`, with no real
kernel. ``pipelined=True`` routes closed batches through the
`DispatchPipeline`: host staging overlaps device compute, because CUDA
launches return before the card finishes, behind a bounded in-flight
window, per-key order preserved and outputs bitwise-equal to serial
dispatch. The queue also hosts the shape-class lifecycle's drain
barrier (`RequestQueue.drain_class`): batches in flight on a retiring
class dispatch through the old executors before invalidation, and new
submissions route to the successor class. ``replicas=N`` scales out: a
`ReplicaSet` owns one executor cache + pipeline per replica lane,
routes each closed batch to the least-loaded replica under key-epoch
pinning (per-key order preserved exactly), aggregates admission
capacity across replicas, and rescues a faulted replica's in-flight
work onto survivors (`ReplicaFault` -> requeue, zero stranded futures).

Failure containment: `chaos` provides deterministic, seeded fault
injection at named sites (dispatch raise, compile failure, device hang,
poisoned member, replica kill) behind the zero-cost-off
``NULL_INJECTOR``; `resilience` contains each of them — bounded inline
retries with seeded backoff, poison-batch quarantine by bisection
(structured `PoisonedRequest`), a dispatch watchdog converting hangs
into retryable timeouts, and SLO-aware brownout shedding
(`BrownoutController`; ``guaranteed=True`` traffic is exempt).
`run_chaos_smoke` replays the whole taxonomy on a `SimClock` with zero
stranded futures — see docs/ROBUSTNESS.md.
"""
from .chaos import (NULL_INJECTOR, ChaosInjector, FaultPlan, FaultSpec,
                    InjectedFault)
from .frontend import (DEFAULT_DEADLINE_MS, AdmissionError, AdmissionPolicy,
                       RequestFuture, RequestQueue)
from .latency import AggregateLatencyModel, LatencyModel
from .pipeline import DispatchPipeline, InflightBatch
from .replicas import Replica, ReplicaFault, ReplicaSet
from .resilience import (BrownoutController, DispatchWatchdog,
                         PoisonedRequest, ResilienceCoordinator,
                         RetryPolicy, WatchdogTimeout)
from .scheduler import BatchPlan, PendingRequest, Scheduler, pow2_ceil
from .stats import ServerStats, SimClock
from .simulate import (Arrival, StubEngine, StubReplica, StubShapeClass,
                       attach_resolve_probe, bursty_trace, poisson_trace,
                       replay_trace, run_chaos_smoke, run_lifecycle_smoke,
                       run_pipeline_smoke, run_replica_fault_smoke,
                       run_replica_smoke, run_smoke, run_trace_smoke)

__all__ = [
    "DEFAULT_DEADLINE_MS", "AdmissionError", "AdmissionPolicy",
    "RequestFuture", "RequestQueue", "AggregateLatencyModel",
    "LatencyModel", "DispatchPipeline", "InflightBatch", "Replica",
    "ReplicaFault", "ReplicaSet", "BatchPlan", "PendingRequest",
    "Scheduler", "pow2_ceil", "ServerStats", "SimClock", "Arrival",
    "StubEngine", "StubReplica", "StubShapeClass", "attach_resolve_probe",
    "bursty_trace", "poisson_trace", "replay_trace", "run_lifecycle_smoke",
    "run_pipeline_smoke", "run_replica_fault_smoke", "run_replica_smoke",
    "run_smoke", "run_trace_smoke",
    "NULL_INJECTOR", "ChaosInjector", "FaultPlan", "FaultSpec",
    "InjectedFault", "BrownoutController", "DispatchWatchdog",
    "PoisonedRequest", "ResilienceCoordinator", "RetryPolicy",
    "WatchdogTimeout", "run_chaos_smoke",
]
