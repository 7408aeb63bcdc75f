"""The benchmark's arithmetic: the card's peaks, the work a request and
an SpMM need, percentiles, the device's busy share, kernel timing.

Nothing here reads the program's own counts: the operations and bytes
come from the benchmark's generated CSR and the configuration's sizes,
so a change of the program's formats cannot move the yardstick.
"""
from __future__ import annotations

import math
import statistics

# NVIDIA H100 SXM data sheet, dense rates: float32 outside the tensor
# cores and HBM3 bandwidth. A card set below its 700 W limit reaches
# less; the run prints the limit beside the numbers it reads.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def gcn_request_flops(n: int, nnz: int, f_in: int, hidden: int,
                      classes: int) -> float:
    """Model FLOPs of one full-graph 2-layer GCN inference on the
    unpadded graph: each layer's dense X·W and its aggregation over the
    nonzeros of A_tilde."""
    return (2.0 * n * f_in * hidden + 2.0 * nnz * hidden
            + 2.0 * n * hidden * classes + 2.0 * nnz * classes)


def spmm_work(n_rows: int, n_cols: int, nnz: int, f: int,
              value_bytes: int = 4, index_bytes: int = 4) -> tuple:
    """(bytes, FLOPs) of Y = A·B at width ``f`` with A in CSR: every
    nonzero's value and column index read once, the row pointers once,
    B read once, Y written once; two operations a nonzero and column."""
    nbytes = (nnz * (value_bytes + index_bytes) + (n_rows + 1) * index_bytes
              + n_cols * f * 4 + n_rows * f * 4)
    return float(nbytes), 2.0 * nnz * f


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes at
    peak bandwidth and the operations at the float32 peak."""
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_F32_FLOPS)


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) by the nearest rank: the
    smallest value with at least q % of the values at or below it.
    Infinity (a failed request) sorts last."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def union_s(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by the union of (start, end)
    intervals."""
    spans = sorted((max(a, lo), min(b, hi)) for a, b in intervals)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The uncovered (start, end) stretches of [lo, hi]."""
    out, t = [], lo
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


GRAPH_CALLS = 10
TIMING_REPS = 15


def device_ms(torch, fn) -> tuple:
    """Device ms of one ``fn()`` call and how it was taken.

    First tries ``GRAPH_CALLS`` calls captured in one CUDA graph,
    replayed ``TIMING_REPS`` times (median per call; no host time
    inside). A call that cannot be captured is timed by CUDA events
    around ``GRAPH_CALLS`` back-to-back calls instead (median per call),
    which includes whatever the host does between launches.
    Returns ``(ms, "graph" | "events")``.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_CALLS):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        run, how = graph.replay, "graph"
    except Exception:  # noqa: BLE001 -- a capture refused: time eagerly
        torch.cuda.synchronize()

        def run():
            for _ in range(GRAPH_CALLS):
                fn()
        how = "events"
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_CALLS)
    return statistics.median(times), how
