"""Analytic ACAP performance model (paper §V).

Port of ``repro.core.cost_model``: the same numpy, with the port's
``grouping`` (Algorithm 1).

The paper's own evaluation is simulation-based ("Vitis Analyzer ... can
accurately model the execution time of AIEs", §V-A). This module is the
same kind of model, parameterized with the paper's published device
measurements, so the paper's tables/figures can be reproduced from our
Algorithm-1/2 implementation on CPU:

  * AIE dense GEMM:  7.1 GFLOPS effective per AIE            (§V-B)
  * AIE SpMM effective GFLOPS (on real nnz) vs density, 32x32 tiles:
      10%:1.6  20%:2.5  30%:3.1  40%:3.4  50%:3.5  60%:3.7   (§V-B)
  * per-size efficiency factors calibrated so the modeled d=0.1 speedup
    matches Fig. 8 (2.9x/2.1x/2.5x at sizes 64/32/16) with Algorithm-1's
    measured padding on uniform-random tiles
  * PL row-wise SpMM 64x64 by 64x32 times at density
      0.1%:0.18us ... 10%:16.82us  => ~1.46 effective GFLOPS  (§V-D)
  * 400 AIEs: 4 rows (200) run A*B, 4 rows (200) run X*W      (§IV-E)
  * measured PL-DDR bandwidth ~70-82 GB/s                     (§V-D)

The published sparse rates are measured *with the paper's own grouping
padding*; our model divides out the typical Algorithm-1 padding on
uniform-random tiles (measured once, below) so that a better/worse
grouping on a real graph shows up as a faster/slower engine — that is
exactly the quantity Algorithms 1+2 are designed to improve.

Flops counted as 2*MAC. All times in seconds.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

GFLOP = 1e9

# §V-B sparse effective GFLOPS per AIE, by tile density (real-nnz flops).
_SPARSE_DENS = np.array([0.10, 0.20, 0.30, 0.40, 0.50, 0.60])
_SPARSE_RATE = np.array([1.6, 2.5, 3.1, 3.4, 3.5, 3.7]) * GFLOP

# Fig. 8 speedups at d=0.1 per tile size -> per-size efficiency factor
# relative to the 32x32 rate curve (32 is the curve's own size).
_BASE_SPEEDUP_01 = 1.6 / (7.1 * 0.1)          # = 2.25x from the curve alone
_SIZE_FACTOR = {16: 2.5 / _BASE_SPEEDUP_01,
                32: 2.1 / _BASE_SPEEDUP_01,
                64: 2.9 / _BASE_SPEEDUP_01}

# §V-D PL SpMM: linear in nnz; 64x64 @ 0.1% by 64x32 takes 0.18us.
# PL_LANES=1 uses the published per-kernel rate as the unit rate.
_PL_SPMM_RATE = (2 * 64 * 64 * 0.001 * 32) / 0.18e-6  # ~1.46 GFLOPS/lane
PL_LANES = 1

DENSE_AIE_RATE = 7.1 * GFLOP
N_AIE = 400
N_AIE_AGG = 200     # upper 4 rows: A * B
N_AIE_COMB = 200    # lower 4 rows: X * W
DDR_BW = 100e9      # peak, §V-A
PL_DDR_BW = 75e9    # typical measured, §V-D


def sparse_aie_rate(density: float) -> float:
    """Effective FLOPS (on real nnz) of the sparse tensor engine per AIE."""
    d = float(np.clip(density, _SPARSE_DENS[0], _SPARSE_DENS[-1]))
    return float(np.interp(d, _SPARSE_DENS, _SPARSE_RATE))


def size_factor(size: int) -> float:
    sizes = sorted(_SIZE_FACTOR)
    s = float(np.clip(size, sizes[0], sizes[-1]))
    return float(np.interp(s, sizes, [_SIZE_FACTOR[k] for k in sizes]))


@functools.lru_cache(maxsize=None)
def typical_padding_density(density_pct: int, size: int = 64) -> float:
    """Algorithm-1 padding density on uniform-random tiles (calibration
    reference for the published rate curve)."""
    from .grouping import group_rows, grouping_density

    rng = np.random.default_rng(1234 + density_pct + size)
    vals = []
    for _ in range(8):
        a = rng.random((size, size)) < (density_pct / 100.0)
        vals.append(grouping_density(a.sum(axis=1), group_rows(a.sum(axis=1))))
    return float(np.mean(vals))


def sparse_tile_time(real_macs: float, density: float,
                     padding_density: float, *, size: int = 64,
                     n_aies: int = 1) -> float:
    """Sparse-engine time for `real_macs` true MACs at a given tile density
    and OUR grouping's padding density."""
    if real_macs <= 0:
        return 0.0
    d = max(density, 1e-3)
    rate = sparse_aie_rate(d) * size_factor(size)
    typical = typical_padding_density(int(round(d * 100)) or 1, min(size, 64))
    pad_scale = typical / max(padding_density, 1e-3)   # >1 -> we pad more
    return 2.0 * real_macs * pad_scale / (rate * n_aies)


def dense_gemm_time(m: int, k: int, n: int, n_aies: int) -> float:
    return 2.0 * m * k * n / (DENSE_AIE_RATE * n_aies)


def pl_spmm_time(nnz: int, f_cols: int) -> float:
    return 2.0 * nnz * f_cols / (_PL_SPMM_RATE * PL_LANES)


@dataclasses.dataclass(frozen=True)
class EngineTimes:
    combination: float   # X @ W on the dense array
    agg_dense: float     # dense tiles of A on dense STPEs
    agg_sparse: float    # ELL buckets on sparse STPEs
    agg_pl: float        # scattered COO on PL
    ddr: float           # off-chip traffic at measured PL-DDR bandwidth

    @property
    def pipelined(self) -> float:
        """§IV-E: combination overlaps aggregation; the dense and sparse
        STPE rows run concurrently with the PL; DDR overlaps compute."""
        agg = max(self.agg_dense + self.agg_sparse, self.agg_pl)
        return max(self.combination, agg, self.ddr)

    @property
    def unpipelined(self) -> float:
        agg = max(self.agg_dense + self.agg_sparse, self.agg_pl)
        return self.combination + agg + self.ddr


def gcn_inference_time(meta, n_features: int, hidden: int, n_classes: int,
                       x_density: float = 1.0) -> EngineTimes:
    """Model the paper's 2-layer GCN (hidden=128) on one graph.

    `meta` is a PartitionMeta of the normalized adjacency. Combination is
    X@W1 and H@W2 on the dense array; aggregation is A@B per layer split
    across the three engines according to the partition."""
    n = meta.n_rows
    f_layers = [(n_features, hidden), (hidden, n_classes)]

    comb = (dense_gemm_time(n, n_features, hidden, N_AIE_COMB)
            * max(x_density, 0.05)
            + dense_gemm_time(n, hidden, n_classes, N_AIE_COMB))

    ell_density = meta.nnz_ell / max(meta.nnz_ell_padded, 1)
    tile_density = min(max(meta.nnz_ell / max(
        meta.tile ** 2 * max(len(meta.ell_ks), 1), 1), 0.0), 1.0)
    agg_d = agg_s = agg_pl = 0.0
    for _, fo in f_layers:
        agg_d += dense_gemm_time(meta.tile, meta.tile, fo, N_AIE_AGG) \
            * meta.n_dense_tiles
        agg_s += sparse_tile_time(meta.nnz_ell * fo,
                                  max(tile_density, 0.1), ell_density,
                                  size=meta.tile, n_aies=N_AIE_AGG)
        agg_pl += pl_spmm_time(meta.nnz_coo, fo)

    # off-chip traffic: features in, adjacency (CSR), logits out
    bytes_total = 4.0 * (n * n_features * x_density + meta.nnz * 2
                         + n * n_classes)
    ddr = bytes_total / PL_DDR_BW
    return EngineTimes(comb, agg_d, agg_s, agg_pl, ddr)


def grouping_speedup(size: int, density: float, padded_density: float) -> dict:
    """Model Fig. 8: speedup of the grouped (CSR-fixed-nnz) sparse engine
    over dense GEMM on one AIE tile, plus the CSR-variable-nnz
    anti-baseline (the paper reports it *slower* than dense because the
    AIE compiler cannot pipeline variable-trip loops)."""
    f_cols = size
    dense_t = dense_gemm_time(size, size, f_cols, 1)
    real_macs = density * size * size * f_cols
    fixed_t = sparse_tile_time(real_macs, density, padded_density, size=size)
    var_t = dense_t * (2.0 + 12.0 * density)
    return {"dense": dense_t, "csr_fixed": fixed_t, "csr_variable": var_t,
            "speedup_fixed": dense_t / max(fixed_t, 1e-30),
            "speedup_variable": dense_t / var_t}
