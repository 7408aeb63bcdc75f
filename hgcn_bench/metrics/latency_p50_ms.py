"""latency_p50_ms: the median request latency, each request timed from
its due time to the resolution of its future (host clock); a failed or
unresolved request counts as infinite."""
from hgcn_bench.yardstick import percentile


def read(ctx):
    lat = ctx.latencies_ms()
    return percentile(lat, 50) if lat else None
