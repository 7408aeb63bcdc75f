"""The deterministic fixture graph the launch and kernel passes analyze.

Port of ``repro.analysis.static.fixtures``: the same adjacency, weights
and features from the same seeds, registered on the port's ``Engine``.
Both passes need a concrete registered graph: the launch pass runs the
engine's real dispatch path over it, and the kernel pass audits the
launch contracts its shape class implies. One shared constructor keeps the
two passes looking at the same thing — a small matrix with all three
density regimes (a dense cluster, a medium band, scattered nnz) so the
partition exercises dense tiles, ragged ELL units, and COO residue.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import csr_from_dense
from repro_torch.core.partition import PartitionConfig, analyze_and_partition
from repro_torch.engine.serving import Engine

FIXTURE_N = 256
FIXTURE_F_IN = 48       # deliberately not a multiple of 4 x 32 features
FIXTURE_F_HID = 32
FIXTURE_F_OUT = 8
# the GAT fixture: a layer of 4 heads x 8 concatenated, then 6 heads x 3
# averaged (head widths that are and are not whole 16-byte rows)
FIXTURE_GAT_HEADS = ((4, 8), (6, 3))


def fixture_adjacency(n: int = FIXTURE_N, seed: int = 7) -> np.ndarray:
    """Tri-regime adjacency: ~25% dense cluster, ~30% medium band,
    scattered residue — enough of each that the tri-partition is
    non-degenerate on every slice."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    d = n // 4
    m = max(n * 3 // 10, 8)
    a[:d, :d] = (rng.random((d, d)) < 0.85) * rng.standard_normal((d, d))
    a[d:d + m, d:d + m] = ((rng.random((m, m)) < 0.12)
                           * rng.standard_normal((m, m)))
    a += ((rng.random((n, n)) < 0.004)
          * rng.standard_normal((n, n))).astype(np.float32)
    return a.astype(np.float32)


def fixture_weights(f_in: int = FIXTURE_F_IN, f_hid: int = FIXTURE_F_HID,
                    f_out: int = FIXTURE_F_OUT, seed: int = 11) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((f_in, f_hid)).astype(np.float32),
            rng.standard_normal((f_hid, f_out)).astype(np.float32)]


def fixture_partition(n: int = FIXTURE_N, seed: int = 7):
    """(part, meta) of the fixture adjacency under the engine default
    tile."""
    csr = csr_from_dense(fixture_adjacency(n, seed))
    part, meta, _ = analyze_and_partition(csr, PartitionConfig(tile=64))
    return part, meta


def fixture_engine(device="cuda", name: str = "lint-fixture",
                   **engine_kw) -> Engine:
    """An Engine on ``device`` (the hand kernels' ``cuda`` backend by
    default) with the fixture graph registered, weights attached."""
    eng = Engine(device=device, **engine_kw)
    csr = csr_from_dense(fixture_adjacency())
    eng.register(name, csr, weights=fixture_weights())
    return eng


def fixture_x(n_cols: int, f_in: int = FIXTURE_F_IN,
              seed: int = 13) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_cols, f_in)).astype(np.float32)


def fixture_gat_layers(f_in: int = FIXTURE_F_IN, seed: int = 17) -> list:
    """The GAT fixture's layers (``core.gat.GatLayer``): the heads and
    widths of ``FIXTURE_GAT_HEADS``, ELU then none, the last averaged."""
    from repro_torch.core.gat import GatLayer

    rng = np.random.default_rng(seed)
    out, f = [], f_in
    for i, (h, fh) in enumerate(FIXTURE_GAT_HEADS):
        last = i == len(FIXTURE_GAT_HEADS) - 1
        out.append(GatLayer(
            (rng.standard_normal((f, h * fh)) / np.sqrt(f)).astype(
                np.float32),
            rng.standard_normal((h, fh)).astype(np.float32),
            rng.standard_normal((h, fh)).astype(np.float32),
            concat=not last, elu=not last))
        f = h * fh
    return out


def fixture_gat_engine(device="cuda", name: str = "lint-fixture-gat",
                       **engine_kw) -> Engine:
    """An Engine on ``device`` with the fixture graph (as A + I's
    pattern) registered as a GAT of ``fixture_gat_layers``."""
    eng = Engine(device=device, **engine_kw)
    a = fixture_adjacency()
    a = ((a != 0) | np.eye(a.shape[0], dtype=bool)).astype(np.float32)
    eng.register(name, csr_from_dense(a), weights=fixture_gat_layers(),
                 model="gat")
    return eng
