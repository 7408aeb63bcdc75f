"""reorder_s: host seconds of ``Engine.register``'s ``reorder`` phase on
the run's graph, the vertex reorder and its inverse permutation
(``GraphHandle.phases``; a ``register`` span's child where a tracer is
attached)."""
from hgcn_bench import devtrace


def read(ctx):
    return devtrace.register_phase_s(ctx, "reorder")
