"""partition_s: host seconds of ``Engine.register``'s ``partition`` phase
on the run's graph, ``analyze_and_partition``, Algorithms 1 and 2
(``GraphHandle.phases``; a ``register`` span's child where a tracer is
attached)."""
from hgcn_bench import devtrace


def read(ctx):
    return devtrace.register_phase_s(ctx, "partition")
