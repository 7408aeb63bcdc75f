"""GraphSAGE-style fanout neighbor sampler for minibatch GNN training
(port of ``repro.data.sampler``: the same numpy, so the same seed gives
the same batches).

Produces *static-shape* padded subgraph batches (jit-friendly): seed nodes
+ per-hop sampled neighbors, relabelled to a compact id space, padded to
the worst-case node/edge counts implied by the fanout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    """Padded, relabelled k-hop subgraph. Padding nodes/edges point at the
    sentinel slot (last node) with zero features; models built on
    segment_sum are padding-safe by construction."""

    node_ids: np.ndarray     # [max_nodes] global ids (pad = -1)
    senders: np.ndarray      # [max_edges] local ids (pad = max_nodes - 1)
    receivers: np.ndarray    # [max_edges]
    edge_mask: np.ndarray    # [max_edges] bool
    node_mask: np.ndarray    # [max_nodes] bool
    seed_count: int          # first `seed_count` locals are the seeds


def max_sizes(batch_nodes: int, fanout) -> tuple:
    """Worst-case (nodes, edges) of a fanout tree, +1 sentinel node."""
    nodes, frontier, edges = batch_nodes, batch_nodes, 0
    for f in fanout:
        edges += frontier * f
        frontier *= f
        nodes += frontier
    return nodes + 1, edges


class NeighborSampler:
    def __init__(self, adj: sp.csr_matrix, batch_nodes: int, fanout,
                 seed: int = 0):
        self.adj = adj.tocsr()
        self.batch_nodes = batch_nodes
        self.fanout = tuple(fanout)
        self.rng = np.random.default_rng(seed)
        self.max_nodes, self.max_edges = max_sizes(batch_nodes, fanout)

    def sample(self, seeds: np.ndarray = None) -> SampledBatch:
        n = self.adj.shape[0]
        if seeds is None:
            seeds = self.rng.choice(n, self.batch_nodes, replace=False)
        indptr, indices = self.adj.indptr, self.adj.indices

        local = {int(v): i for i, v in enumerate(seeds)}
        nodes = list(map(int, seeds))
        s_list, r_list = [], []
        frontier = list(map(int, seeds))
        for f in self.fanout:
            nxt = []
            for v in frontier:
                lo, hi = indptr[v], indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, deg)
                picks = indices[lo + self.rng.choice(deg, take,
                                                     replace=False)]
                for u in map(int, picks):
                    if u not in local:
                        local[u] = len(nodes)
                        nodes.append(u)
                        nxt.append(u)
                    # message u -> v
                    s_list.append(local[u])
                    r_list.append(local[v])
            frontier = nxt

        node_ids = np.full(self.max_nodes, -1, np.int64)
        node_ids[: len(nodes)] = nodes
        sent = self.max_nodes - 1
        senders = np.full(self.max_edges, sent, np.int32)
        receivers = np.full(self.max_edges, sent, np.int32)
        senders[: len(s_list)] = s_list
        receivers[: len(r_list)] = r_list
        edge_mask = np.zeros(self.max_edges, bool)
        edge_mask[: len(s_list)] = True
        node_mask = np.zeros(self.max_nodes, bool)
        node_mask[: len(nodes)] = True
        return SampledBatch(node_ids, senders, receivers, edge_mask,
                            node_mask, self.batch_nodes)
