"""slot_wait_ms.online: the median over the window's requests of the
program's ``slot_wait`` span of each one's batch (host ms the staging
worker waited for a free in-flight slot before the enqueue), spans begun
inside the window. On the card only: off it the forward runs inside the
enqueue and a slot is never held by device work."""
from hgcn_bench import devtrace


def read(ctx):
    if not devtrace.on_card(ctx):
        return None
    spans = devtrace.host_spans(ctx, "slot_wait")
    return devtrace.median_or_none(
        [1e3 * s for _, s, args in spans or () for _ in args["reqs"]])
