"""latency_p95_ms: the 95th percentile of all the window's request
latencies, timed as for latency_p50_ms."""
from hgcn_bench.yardstick import percentile


def read(ctx):
    lat = ctx.latencies_ms()
    return percentile(lat, 95) if lat else None
