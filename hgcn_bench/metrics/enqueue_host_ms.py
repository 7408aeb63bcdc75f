"""enqueue_host_ms: the median of the program's ``enqueue`` spans (host
ms of ``Engine.serve_group_async``, entry to return) begun inside the
window."""
from hgcn_bench import devtrace


def read(ctx):
    spans = devtrace.host_spans(ctx, "enqueue")
    return devtrace.median_or_none([1e3 * s for _, s, _ in spans or ()])
