"""place_s: host seconds of ``Engine.register``'s ``place`` phase on the
run's graph, the class fit, the padding to the class, the reduction plan
and the placement on the device (``GraphHandle.phases``; a ``register``
span's child where a tracer is attached)."""
from hgcn_bench import devtrace


def read(ctx):
    return devtrace.register_phase_s(ctx, "place")
