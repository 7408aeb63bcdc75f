"""stage_dev_ms: device ms a request of the program's ``stage`` segments,
the features' permutation gather, padding and group stack (the staging
worker's ``prepare_x`` pairs and the dispatch's own stack): summed over
the dispatches enqueued inside the window, over their live requests (the
program's device segments: CUDA events on the tracer's clock on the
card, host intervals of the synchronous work off it)."""
from hgcn_bench import devtrace


def read(ctx):
    return devtrace.dev_ms(ctx, "stage")
