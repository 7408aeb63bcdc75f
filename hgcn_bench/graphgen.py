"""The benchmark's graphs: a frozen copy of the port's SBM generator.

``sbm_graph`` and ``normalized_adjacency`` are copied from
``repro_torch/data/graphs.py`` as they stand when the benchmark was
written, so a later change to the program's generator cannot change
the benchmark's inputs. A test holds this copy to the program's
``make_paper_dataset`` CSR at a small scale.

``load_graph(cfg)`` returns the normalized adjacency of a configuration
(scipy CSR, float32) and the planted communities, caching both under
``hgcn_bench/.cache/graphs`` by a hash of the configuration's graph
block: generating Reddit takes about 12 s, loading it well under one.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path

import numpy as np
import scipy.sparse as sp

CACHE_DIR = Path(__file__).resolve().parent / ".cache" / "graphs"


def sbm_graph(n: int, n_edges: int, *, n_communities: int = 0,
              intra_frac: float = 0.9, seed: int = 0,
              power_law: bool = True, return_labels: bool = False,
              fill: bool = False):
    """Undirected SBM with power-law-ish degrees; ~n_edges directed nnz.

    With ``return_labels`` returns ``(a, comm)``: the planted community
    of every vertex. Without ``fill`` this is the program's generator,
    draw for draw: repeated draws of one pair collapse, so A keeps fewer
    than ``n_edges`` nonzeros. With ``fill`` the same generator goes on
    drawing from the same distribution until A holds ``n_edges``
    nonzeros (rounded down to even, as A is symmetric); see ``_fill``.
    """
    rng = np.random.default_rng(seed)
    if n_communities == 0:
        n_communities = max(n // 112, 2)
    comm = rng.integers(0, n_communities, n)
    m = n_edges // 2

    if power_law:
        w = (np.arange(n) + 2.0) ** -0.8
        rng.shuffle(w)
        w /= w.sum()
    else:
        w = np.full(n, 1.0 / n)

    order = np.argsort(comm, kind="stable")
    comm_sorted = comm[order]
    starts = np.searchsorted(comm_sorted, np.arange(n_communities))
    ends = np.searchsorted(comm_sorted, np.arange(n_communities),
                           side="right")

    def draw(m):
        """``m`` undirected draws, ``intra_frac`` of them inside the
        source's community: (sources, destinations)."""
        n_intra = int(m * intra_frac)
        src = rng.choice(n, size=n_intra, p=w)
        cs = comm[src]
        lo, hi = starts[cs], ends[cs]
        dst = order[(lo + rng.random(n_intra) * (hi - lo)).astype(np.int64)]
        src2 = rng.choice(n, size=m - n_intra, p=w)
        dst2 = rng.integers(0, n, m - n_intra)
        return np.concatenate([src, src2]), np.concatenate([dst, dst2])

    src, dst = draw(m)
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    a = sp.coo_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)),
                      shape=(n, n)).tocsr()
    a.data[:] = 1.0
    a.setdiag(0)
    a.eliminate_zeros()
    if fill:
        a = _fill(a, n_edges - n_edges % 2, draw, rng)
    if return_labels:
        return a, comm
    return a


# a fill that draws this many rounds has stopped finding new pairs
FILL_ROUNDS = 64


def _fill(a: sp.csr_matrix, target: int, draw, rng) -> sp.csr_matrix:
    """A with more of ``draw``'s pairs until it holds ``target`` nonzeros.

    Each round draws enough pairs to cover what is missing at the share
    of new pairs the last round found, keeps the pairs that are new (no
    loop, not in A, not drawn twice), and takes a random subset of them
    where they are more than is missing, so A ends at ``target``
    exactly. Deterministic for one seed."""
    n = a.shape[0]
    up = sp.triu(a, k=1).tocoo()
    have = np.unique(up.row.astype(np.int64) * n + up.col)
    want = target // 2
    share = 1.0
    for _ in range(FILL_ROUNDS):
        need = want - have.shape[0]
        if need <= 0:
            break
        m = int(min(math.ceil(1.1 * need / share), 8 * want))
        src, dst = draw(m)
        keys = np.unique(np.minimum(src, dst) * n + np.maximum(src, dst))
        keys = keys[(keys // n) != (keys % n)]
        new = keys[~np.isin(keys, have, assume_unique=True)]
        share = max(new.shape[0] / m, 1e-3)
        if new.shape[0] > need:
            new = np.sort(rng.choice(new, size=need, replace=False))
        have = np.union1d(have, new)
    else:
        raise RuntimeError(f"SBM fill: {2 * have.shape[0]} of {target} "
                           f"nonzeros after {FILL_ROUNDS} rounds")
    r, c = have // n, have % n
    rows = np.concatenate([r, c])
    cols = np.concatenate([c, r])
    return sp.csr_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)),
                         shape=(n, n))


def normalized_adjacency(a: sp.csr_matrix) -> sp.csr_matrix:
    """A_tilde = D^-1/2 (A + I) D^-1/2."""
    n = a.shape[0]
    abar = (a + sp.eye(n, format="csr", dtype=np.float32)).tocsr()
    deg = np.asarray(abar.sum(axis=1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    return (sp.diags(dinv) @ abar @ sp.diags(dinv)).tocsr().astype(np.float32)


def generate(graph: dict):
    """(A_tilde as a canonical scipy CSR float32, planted communities)
    of a configuration's ``graph`` block, as ``make_paper_dataset``
    builds them: n vertices, density * n^2 requested directed edges (at
    least 4n), the SBM seeded by ``graph_seed``. With ``"fill": true``
    in the block, A holds that many nonzeros, not what the draws keep
    after repeated pairs collapse."""
    n = int(graph["n_vertices"])
    n_edges = max(int(graph["density"] * n * n), 4 * n)
    a, labels = sbm_graph(n, n_edges, seed=int(graph["graph_seed"]),
                          return_labels=True,
                          fill=bool(graph.get("fill", False)))
    atil = normalized_adjacency(a).tocsr()
    atil.sum_duplicates()
    atil.sort_indices()
    return atil, labels.astype(np.int64)


def graph_key(graph: dict) -> str:
    blob = json.dumps(graph, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def load_graph(name: str, graph: dict, cache_dir: Path = CACHE_DIR):
    """``generate(graph)``, from the cache when it holds this block.

    Returns ``(atil, labels, cached)``. The file is written once, under
    a temporary name and renamed, so a run cut off mid-write leaves no
    half file behind.
    """
    path = Path(cache_dir) / f"{name}-{graph_key(graph)}.npz"
    if path.exists():
        with np.load(path) as z:
            atil = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                                 shape=tuple(z["shape"]))
            return atil, z["labels"], True
    atil, labels = generate(graph)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, data=atil.data, indices=atil.indices, indptr=atil.indptr,
             shape=np.asarray(atil.shape), labels=labels)
    os.replace(tmp, path)
    return atil, labels, False
