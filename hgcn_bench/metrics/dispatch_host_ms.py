"""dispatch_host_ms: host ms from entry to return of the engine's
``serve_group_async`` (the enqueue alone), median over the dispatches
enqueued inside the window."""
import statistics


def read(ctx):
    rows = ctx.dispatch_rows()
    if not rows:
        return None
    return statistics.median(r[1] for r in rows) * 1e3
