"""Synthetic graph generation matching the paper's dataset statistics.

Port of the graph part of ``repro.data.graphs``: the same generator, so
the same seed gives the same CSR as the reference.

The real datasets are not shipped, so Cora/Citeseer/... are synthesized
as stochastic block-model graphs with the same (n_vertices, density,
n_features) as Table I — SBM community structure is exactly the
heterogeneity ("tightly clustered / loosely clustered / scattered") the
paper's partitioner exploits, so the partition statistics are realistic.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import scipy.sparse as sp

from repro_torch.core.formats import csr_from_scipy


@dataclasses.dataclass(frozen=True)
class DatasetStats:
    name: str
    n_vertices: int
    density: float          # of A (Table I)
    n_features: int
    n_classes: int = 16


# Table I of the paper.
PAPER_DATASETS = {
    "cora": DatasetStats("cora", 2708, 0.0014, 1433, 7),
    "citeseer": DatasetStats("citeseer", 3327, 0.0008, 3703, 6),
    "pubmed": DatasetStats("pubmed", 19717, 0.00023, 500, 3),
    "flickr": DatasetStats("flickr", 89250, 0.00011, 500, 7),
    "reddit": DatasetStats("reddit", 232965, 0.0004, 602, 41),
    "yelp": DatasetStats("yelp", 716847, 0.000027, 300, 100),
    "amazon": DatasetStats("amazon", 1569960, 0.00011, 200, 107),
}


def sbm_graph(n: int, n_edges: int, *, n_communities: int = 0,
              intra_frac: float = 0.9, seed: int = 0,
              power_law: bool = True):
    """Undirected SBM with power-law-ish degrees; ~n_edges directed nnz."""
    rng = np.random.default_rng(seed)
    if n_communities == 0:
        # real-world community sizes are O(100) vertices; ~112 gives the
        # paper's Fig-4 morphology (dense diagonal rectangles of a few
        # tiles) at Table-I average degrees
        n_communities = max(n // 112, 2)
    comm = rng.integers(0, n_communities, n)
    m = n_edges // 2

    if power_law:
        w = (np.arange(n) + 2.0) ** -0.8
        rng.shuffle(w)
        w /= w.sum()
    else:
        w = np.full(n, 1.0 / n)

    n_intra = int(m * intra_frac)
    # intra-community edges: pick src by weight, dst within same community
    order = np.argsort(comm, kind="stable")
    comm_sorted = comm[order]
    starts = np.searchsorted(comm_sorted, np.arange(n_communities))
    ends = np.searchsorted(comm_sorted, np.arange(n_communities),
                           side="right")
    src = rng.choice(n, size=n_intra, p=w)
    cs = comm[src]
    lo, hi = starts[cs], ends[cs]
    dst = order[(lo + rng.random(n_intra) * (hi - lo)).astype(np.int64)]

    src2 = rng.choice(n, size=m - n_intra, p=w)
    dst2 = rng.integers(0, n, m - n_intra)

    rows = np.concatenate([src, src2, dst, dst2])
    cols = np.concatenate([dst, dst2, src, src2])
    a = sp.coo_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)),
                      shape=(n, n)).tocsr()
    a.data[:] = 1.0
    a.setdiag(0)
    a.eliminate_zeros()
    return a


def normalized_adjacency(a: sp.csr_matrix) -> sp.csr_matrix:
    """The paper's A_tilde = D^-1/2 (A + I) D^-1/2."""
    n = a.shape[0]
    abar = (a + sp.eye(n, format="csr", dtype=np.float32)).tocsr()
    deg = np.asarray(abar.sum(axis=1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    return (sp.diags(dinv) @ abar @ sp.diags(dinv)).tocsr().astype(np.float32)


def make_paper_dataset(name: str, *, scale: float = 1.0, seed: int = 0):
    """Synthesize a Table-I-alike: returns (A_tilde CSR, X, labels, stats).

    ``scale`` < 1 shrinks vertices (keeping density). The features are
    seeded with a CRC32 of the name, which (unlike the reference's
    ``hash(name)``) does not change with ``PYTHONHASHSEED``; the CSR does
    not depend on it.
    """
    st = PAPER_DATASETS[name]
    n = max(int(st.n_vertices * scale), 64)
    n_edges = max(int(st.density * n * n), 4 * n)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2 ** 31))
    a = sbm_graph(n, n_edges, seed=seed)
    atil = normalized_adjacency(a)
    x = (rng.random((n, st.n_features)) < 0.05).astype(np.float32)
    y = rng.integers(0, st.n_classes, n).astype(np.int32)
    return csr_from_scipy(atil), x, y, dataclasses.replace(st)
