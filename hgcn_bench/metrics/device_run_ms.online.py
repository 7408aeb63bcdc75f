"""device_run_ms.online: the median over the requests of the
dispatches enqueued inside the window of each one's batch on the device:
ms from the dispatch's first device event to its last. On the card
only."""
from hgcn_bench import devtrace


def read(ctx):
    if not devtrace.on_card(ctx):
        return None
    return devtrace.median_or_none(devtrace.per_request_ms(
        ctx, lambda r: r["last"] - r["first"]))
