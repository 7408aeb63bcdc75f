"""Input graph reordering (paper §IV-B).

Port of ``repro.core.reorder`` (host numpy/scipy, unchanged).

The paper reorders vertices once, offline, with mt-metis so that vertices
sharing neighbors land together, concentrating nnz of the normalized
adjacency into dense rectangular blocks near the diagonal. mt-metis is not
available here, so we implement three orderings with the same goal:

  * ``rcm``       — reverse Cuthill-McKee (scipy), classic bandwidth
                    minimizer; the default.
  * ``community`` — lightweight label-propagation communities, communities
                    sorted by size, vertices inside a community sorted by
                    degree (the paper: "sort vertices into a community based
                    on their degrees").
  * ``degree``    — plain degree sort (ablation baseline).
  * ``identity``  — no reordering (ablation baseline).
  * ``labels``    — order by given cluster ids, then degree.

A reordering is a permutation ``perm`` with ``A' = A[perm][:, perm]``; it
never changes the graph, only the execution order (paper §IV-B).
"""
from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from .formats import CSRMatrix, csr_from_scipy, csr_to_scipy

STRATEGIES = ("rcm", "community", "degree", "identity", "labels")


def _label_propagation(adj: sp.csr_matrix, max_iters: int = 8,
                       seed: int = 0) -> np.ndarray:
    """Vectorized-ish label propagation. O(E) per sweep using bincount over
    edge labels; deterministic given the seed (ties broken by smallest
    label). Good enough as an offline preprocessing stage — the paper runs
    METIS offline too (Table IV)."""
    n = adj.shape[0]
    labels = np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(seed)
    indptr, indices = adj.indptr, adj.indices
    order = np.arange(n)
    for _ in range(max_iters):
        changed = 0
        rng.shuffle(order)
        for u in order:
            s, e = indptr[u], indptr[u + 1]
            if s == e:
                continue
            neigh = labels[indices[s:e]]
            counts = np.bincount(neigh)
            best = int(np.argmax(counts))
            if counts[best] > 0 and best != labels[u]:
                labels[u] = best
                changed += 1
        if changed == 0:
            break
    return labels


def compute_permutation(a: CSRMatrix, strategy: str = "rcm",
                        seed: int = 0, labels=None) -> np.ndarray:
    """Return the vertex permutation for a given strategy.

    ``labels``: optional per-vertex cluster ids for strategy="labels" —
    the mt-metis stand-in when a high-quality clustering is available
    (e.g. the planted SBM communities of the synthetic datasets, or an
    external partitioner's output). Vertices are ordered by
    (cluster, degree desc), the paper's "sort vertices into a community
    based on their degrees".
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown reorder strategy {strategy!r}; "
                         f"choose from {STRATEGIES}")
    n = a.shape[0]
    if strategy == "identity":
        return np.arange(n, dtype=np.int64)
    if strategy == "labels":
        if labels is None:
            raise ValueError("strategy='labels' requires labels")
        m = csr_to_scipy(a)
        deg = np.diff((m + m.T).tocsr().indptr)
        return np.lexsort((-deg, np.asarray(labels))).astype(np.int64)

    m = csr_to_scipy(a)
    sym = (m + m.T).tocsr()  # orderings want an undirected structure

    if strategy == "degree":
        deg = np.diff(sym.indptr)
        return np.argsort(-deg, kind="stable").astype(np.int64)

    if strategy == "rcm":
        return np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True),
                          dtype=np.int64)

    # community: LP labels, then (community-size desc, degree desc) order.
    # Label propagation is a python sweep — cap it to moderate graphs and
    # fall back to RCM beyond that.
    if sym.nnz > 2_000_000:
        return np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True),
                          dtype=np.int64)
    labels = _label_propagation(sym, seed=seed)
    deg = np.diff(sym.indptr)
    uniq, inv, counts = np.unique(labels, return_inverse=True,
                                  return_counts=True)
    comm_size = counts[inv]
    # big communities first, then by community id, then degree desc
    key = np.lexsort((-deg, inv, -comm_size))
    return key.astype(np.int64)


def apply_permutation(a: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Symmetric permutation A' = A[perm][:, perm]."""
    m = csr_to_scipy(a)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    pm = m[perm][:, perm]
    return csr_from_scipy(pm)


def reorder(a: CSRMatrix, strategy: str = "rcm", seed: int = 0,
            labels=None):
    """Reorder a graph; returns (A', perm, elapsed_seconds).

    ``elapsed_seconds`` reproduces Table IV (reordering overhead).
    """
    t0 = time.perf_counter()
    perm = compute_permutation(a, strategy, seed, labels=labels)
    a2 = apply_permutation(a, perm)
    return a2, perm, time.perf_counter() - t0


def bandwidth(a: CSRMatrix) -> int:
    """Matrix bandwidth — a scalar proxy for 'how diagonal' the layout is."""
    m = csr_to_scipy(a).tocoo()
    if m.nnz == 0:
        return 0
    return int(np.max(np.abs(m.row - m.col)))


def tile_density_histogram(a: CSRMatrix, tile: int = 128) -> np.ndarray:
    """Per-tile densities (used to visualize the Fig. 4 effect and to pick
    partition thresholds)."""
    m = csr_to_scipy(a).tocoo()
    nrt = -(-a.shape[0] // tile)
    nct = -(-a.shape[1] // tile)
    counts = np.zeros((nrt, nct), np.int64)
    np.add.at(counts, (m.row // tile, m.col // tile), 1)
    return counts / float(tile * tile)
