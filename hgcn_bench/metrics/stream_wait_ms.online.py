"""stream_wait_ms.online: the median over the requests of the
dispatches enqueued inside the window of each one's wait on the stream:
host ms from the enqueue's entry to the dispatch's first device event
(the work ahead of it on the stream). On the card only."""
from hgcn_bench import devtrace


def read(ctx):
    if not devtrace.on_card(ctx):
        return None
    return devtrace.median_or_none(devtrace.per_request_ms(
        ctx, lambda r: r["first"] - r["enqueued"]))
