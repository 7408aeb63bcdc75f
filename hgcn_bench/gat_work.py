"""The work a GAT request needs, for the GAT's roofline shares: counted
from the benchmark's generated CSR and the configuration's widths, never
from the program's own counts (as ``yardstick``, whose peaks and bound
it uses).
"""
from __future__ import annotations

from hgcn_bench import yardstick


def layers(config: dict) -> list:
    """(heads, aggregated width H * F') of each layer of a ``gat``
    configuration."""
    return [(int(lay["heads"]), int(lay["heads"]) * int(lay["head_width"]))
            for lay in config["model"]["layers"]]


def row_stats_work(n: int, nnz: int, heads: int) -> tuple:
    """(bytes, FLOPs) of one layer's softmax statistics, whatever
    computes them: the neighbour lists' column indices (4 bytes a stored
    entry) and row pointers (4 bytes a row) read once, s and t read once
    per node and head, one maximum and one denominator written per row
    and head (4 bytes each); five operations a stored entry and head
    (the add, LeakyReLU, the subtraction, the exponential and the
    sum)."""
    nbytes = 4.0 * nnz + 4.0 * (n + 1) + 4.0 * 2 * n * heads \
        + 4.0 * 2 * n * heads
    return nbytes, 5.0 * nnz * heads


def attn_bound_s(config: dict, n: int, nnz: int) -> float:
    """The least time the card could take for the three layers' row
    statistics: each layer's bound (``yardstick.bound_s``), summed."""
    return sum(yardstick.bound_s(*row_stats_work(n, nnz, h))
               for h, _ in layers(config))


def agg_bound_s(config: dict, n: int, nnz: int) -> float:
    """The least time for the three layers' aggregation: each layer's
    ``yardstick.spmm_work`` at its width H * F' with no stored values
    (the coefficients are the request's own, made on the card), summed
    bounds."""
    return sum(yardstick.bound_s(*yardstick.spmm_work(n, n, nnz, f,
                                                      value_bytes=0))
               for _, f in layers(config))
