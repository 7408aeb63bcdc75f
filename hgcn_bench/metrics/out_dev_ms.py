"""out_dev_ms: device ms a request of the program's ``out`` segments, each
layer's slice, type and activation, and after the last the unpadding and
the inverse permutation: summed over the dispatches enqueued inside the
window, over their live requests (the program's device segments: CUDA
events on the tracer's clock on the card, host intervals of the
synchronous work off it)."""
from hgcn_bench import devtrace


def read(ctx):
    return devtrace.dev_ms(ctx, "out")
