"""ell_dev_ms: device ms a request of the program's ``ell`` segments, the
ELL engine of both layers, with its sum onto the dense engine's rows:
summed over the dispatches enqueued inside the window, over their live
requests (the program's device segments: CUDA events on the tracer's
clock on the card, host intervals of the synchronous work off it)."""
from hgcn_bench import devtrace


def read(ctx):
    return devtrace.dev_ms(ctx, "ell")
