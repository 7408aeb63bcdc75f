"""dense_dev_ms: device ms a request of the program's ``dense`` segments,
the dense-tile engine of both layers: summed over the dispatches
enqueued inside the window, over their live requests (the program's
device segments: CUDA events on the tracer's clock on the card, host
intervals of the synchronous work off it)."""
from hgcn_bench import devtrace


def read(ctx):
    return devtrace.dev_ms(ctx, "dense")
