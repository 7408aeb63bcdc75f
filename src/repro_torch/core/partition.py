"""Algorithm 2 — density-aware tile analysis and tri-partition construction.

Port of ``repro.core.partition``: host numpy, the same arithmetic, so the
port's partitions equal the reference's array for array.

Pipeline (host-side, offline — mirrors the paper's ahead-of-time AIE
codegen):

  1. Tile A (reordered) into T×T tiles and classify each tile by density:
       density >= d_dense   -> dense engine   (tightly clustered)
       density >= d_scatter -> sparse engine  (loosely clustered)
       else                 -> scattered      (COO, flexible engine)
  2. Per tile-row band, run Algorithm 2 over the sparse-class tiles:
       - per local row j: ave/max nnz across tiles; if max/ave >= delta,
         cap the row's ELL width at the p-coverage quantile (FIND_NNZ),
         else use max. Overflow nnz spill to the scattered path
         ("the remaining non-zeros are calculated by SpMM in PL").
       - Algorithm 1 (moving-average grouping) groups the rows; each group
         is padded to its max width K.
       - if the band's post-padding density >= d_dense, emit dense tensor
         PEs for the whole band instead (Alg. 2 lines 18-19).
  3. Lay out the sparse engine's work as ELL *units* of R_BLOCK×K
     entries, concatenated into ONE ragged array padded to the global
     Kmax with the per-unit K carried alongside (``RaggedEll``) — the
     TPU analogue of "generate sparse tensor PE code for this group"
     where K is a per-tile runtime parameter, not a per-kernel one.
     Units are ordered by DESCENDING K so the ragged kernel's K-band
     grid can shorten trip counts for the sparse tail; the (K, n_units)
     runs stay derivable as static slices (``meta.ell_segments``) for
     the legacy fixed-K buckets.

The construction is exact: dense + ELL + COO reconstructs A bit-for-bit
(`formats.partition_to_dense` is the oracle used in tests).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .formats import (CSRMatrix, CooResidual, DenseTiles, PartitionMeta,
                      RaggedEll, TriPartition, csr_to_scipy)
from .grouping import group_rows, groups_cover_exactly

# Row-block height of one ELL unit, kept equal to the reference's (8, the
# f32 sublane count on a TPU): changing it would break partition parity.
R_BLOCK = 8


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    tile: int = 128          # T (paper: 64; the reference's default)
    d_dense: float = 0.5     # dense-engine threshold (paper §V-A: 50%)
    d_scatter: float = 0.01  # scattered threshold (paper §V-A: 1%)
    delta: float = 4.0       # Alg-2 skew ratio for FIND_NNZ
    p: float = 0.9           # Alg-2 coverage percentage
    tau: float = 0.5         # Alg-1 moving-average threshold
    r_block: int = R_BLOCK


@dataclasses.dataclass
class BandReport:
    """Per-band Algorithm-2 analysis (feeds the cost model + benchmarks)."""

    band: int
    n_sparse_tiles: int
    groups: list
    targets: np.ndarray      # [T] per-local-row ELL width
    kept_nnz: int
    padded_nnz: int
    density: float
    emitted_dense: bool


def find_nnz(nnz_values: np.ndarray, p: float) -> int:
    """Paper's FIND_NNZ: smallest width covering >= p of the tiles' rows."""
    if nnz_values.size == 0:
        return 0
    srt = np.sort(nnz_values)
    idx = min(int(np.ceil(p * srt.size)) - 1, srt.size - 1)
    idx = max(idx, 0)
    return int(srt[idx])


def _tile_nnz_counts(coo_row, coo_col, n_row_tiles, n_col_tiles, tile):
    keys = (coo_row // tile).astype(np.int64) * n_col_tiles + (coo_col // tile)
    counts = np.bincount(keys, minlength=n_row_tiles * n_col_tiles)
    return counts.reshape(n_row_tiles, n_col_tiles)


def analyze_and_partition(a: CSRMatrix, cfg: PartitionConfig = PartitionConfig()):
    """Run Algorithms 1+2 over A and build the device TriPartition.

    Returns (TriPartition, PartitionMeta, list[BandReport]).
    """
    T = cfg.tile
    n_rows, n_cols = a.shape
    nrt = -(-n_rows // T)
    nct = -(-n_cols // T)

    m = csr_to_scipy(a).tocoo()
    row = m.row.astype(np.int64)
    col = m.col.astype(np.int64)
    val = m.data.astype(np.float32)

    tile_nnz = _tile_nnz_counts(row, col, nrt, nct, T)
    tile_density = tile_nnz / float(T * T)
    tile_class = np.zeros((nrt, nct), np.int8)  # 0 scattered, 1 sparse, 2 dense
    tile_class[tile_density >= cfg.d_scatter] = 1
    tile_class[tile_density >= cfg.d_dense] = 2

    nnz_class = tile_class[row // T, col // T]

    # ---- dense tiles (may be appended to by Alg-2 band promotion) --------
    dense_tiles: list = []        # (tile_row, tile_col, TxT ndarray)

    def emit_dense_tile(rt: int, ct: int, mask: np.ndarray):
        buf = np.zeros((T, T), np.float32)
        buf[row[mask] - rt * T, col[mask] - ct * T] = val[mask]
        dense_tiles.append((rt, ct, buf))

    dmask = nnz_class == 2
    if dmask.any():
        drt, dct = row[dmask] // T, col[dmask] // T
        for rt, ct in {(int(r), int(c)) for r, c in zip(drt, dct)}:
            sel = dmask & (row // T == rt) & (col // T == ct)
            emit_dense_tile(rt, ct, sel)

    # ---- scattered residual ----------------------------------------------
    coo_rows = [row[nnz_class == 0]]
    coo_cols = [col[nnz_class == 0]]
    coo_vals = [val[nnz_class == 0]]

    # ---- Algorithm 2 per band over sparse-class tiles ---------------------
    # ELL units accumulated per K: K -> list of (gr0 rows[R], tile_col,
    # cols[R,K], vals[R,K]) with global row ids (padding rows = n_pad_rows).
    units: dict = {}
    reports: list = []
    pad_row_id = nrt * T  # sentinel row for unit padding
    nnz_ell_real = 0
    nnz_ell_padded = 0

    smask_all = nnz_class == 1
    srow, scol, sval = row[smask_all], col[smask_all], val[smask_all]
    sband = srow // T
    band_order = np.argsort(sband, kind="stable")
    srow, scol, sval = srow[band_order], scol[band_order], sval[band_order]
    sband = sband[band_order]
    band_starts = np.searchsorted(sband, np.arange(nrt))
    band_ends = np.searchsorted(sband, np.arange(nrt), side="right")

    for band in range(nrt):
        s, e = band_starts[band], band_ends[band]
        if s == e:
            continue
        brow = srow[s:e] - band * T     # local row in [0, T)
        bcol = scol[s:e]
        bval = sval[s:e]
        btile = (bcol // T).astype(np.int64)
        blocal = (bcol % T).astype(np.int64)

        sp_tiles = np.unique(btile)
        tile_index = {int(t): i for i, t in enumerate(sp_tiles)}
        n_sp = len(sp_tiles)

        # nnz_mat[j, k] = nnz of local row j within sparse tile k
        nnz_mat = np.zeros((T, n_sp), np.int64)
        tidx = np.fromiter((tile_index[int(t)] for t in btile),
                           np.int64, count=len(btile))
        np.add.at(nnz_mat, (brow, tidx), 1)

        ave = nnz_mat.mean(axis=1)
        mx = nnz_mat.max(axis=1)
        targets = mx.copy()
        skewed = (ave > 0) & (mx / np.maximum(ave, 1e-12) >= cfg.delta)
        for j in np.nonzero(skewed)[0]:
            targets[j] = find_nnz(nnz_mat[j], cfg.p)

        groups = group_rows(targets, tau=cfg.tau)
        assert groups_cover_exactly(groups, T)
        k_of_row = np.zeros(T, np.int64)
        for g in groups:
            k_of_row[g.start:g.stop] = g.k

        kept = int(np.minimum(nnz_mat, k_of_row[:, None]).sum())
        padded = int(k_of_row.sum()) * n_sp
        density = 1.0 if padded == 0 else kept / padded
        promote = density >= cfg.d_dense
        reports.append(BandReport(band, n_sp, groups, targets, kept,
                                  padded, density, promote))

        if promote:
            # Alg-2 line 19: emit dense tensor PEs for the whole band.
            for t in sp_tiles:
                sel = btile == t
                buf = np.zeros((T, T), np.float32)
                buf[brow[sel], blocal[sel]] = bval[sel]
                dense_tiles.append((band, int(t), buf))
            continue

        # sort band nnz by (tile, local row, local col) for slicing per row
        order = np.lexsort((blocal, brow, btile))
        brow_o, bloc_o, bval_o, btile_o = (brow[order], blocal[order],
                                           bval[order], btile[order])
        # per (tile k, row j) slice boundaries into the sorted run
        run_key = btile_o * T + brow_o
        bounds = np.searchsorted(
            run_key, (sp_tiles[:, None] * T + np.arange(T)[None, :]).ravel())
        bounds = np.append(bounds, len(run_key))

        for g in groups:
            if g.k == 0:
                continue
            K = int(g.k)
            for c0 in range(g.start, g.stop, cfg.r_block):
                c1 = min(c0 + cfg.r_block, g.stop)
                for ki, t in enumerate(sp_tiles):
                    ucols = np.zeros((cfg.r_block, K), np.int64)
                    uvals = np.zeros((cfg.r_block, K), np.float32)
                    urows = np.full(cfg.r_block, pad_row_id, np.int64)
                    any_nnz = False
                    for rr, j in enumerate(range(c0, c1)):
                        b0 = bounds[ki * T + j]
                        b1 = bounds[ki * T + j + 1]
                        urows[rr] = band * T + j
                        take = min(K, b1 - b0)
                        if take > 0:
                            any_nnz = True
                            ucols[rr, :take] = bloc_o[b0:b0 + take]
                            uvals[rr, :take] = bval_o[b0:b0 + take]
                        if b1 - b0 > K:  # overflow -> scattered path
                            coo_rows.append(band * T + j
                                            + np.zeros(b1 - b0 - take, np.int64))
                            coo_cols.append(btile_o[b0 + take:b1] * T
                                            + bloc_o[b0 + take:b1])
                            coo_vals.append(bval_o[b0 + take:b1])
                    if any_nnz:
                        units.setdefault(K, []).append(
                            (urows, int(t), ucols, uvals))
                        nnz_ell_real += int(np.count_nonzero(uvals))
                        nnz_ell_padded += (c1 - c0) * K

    # ---- assemble device arrays -------------------------------------------
    if dense_tiles:
        dt = DenseTiles(
            tiles=np.stack([b for _, _, b in dense_tiles]).astype(np.float32),
            tile_row=np.asarray([r for r, _, _ in dense_tiles], np.int32),
            tile_col=np.asarray([c for _, c, _ in dense_tiles], np.int32),
        )
    else:
        dt = DenseTiles(tiles=np.zeros((0, T, T), np.float32),
                        tile_row=np.zeros(0, np.int32),
                        tile_col=np.zeros(0, np.int32))

    # One concatenated ragged array, DESCENDING-K unit order (the ragged
    # kernel's K-band grid runs wide chains first and shortens toward
    # the sparse tail); each unit's cols/vals occupy [:K] of the
    # Kmax-wide slab (the rest stays zero). Units within a K run keep
    # emission order, and all units holding a given output row share
    # that row's group K, so the scatter-add order per output row — and
    # therefore the result bits — are identical to any other unit order.
    ks = sorted(units.keys())
    kmax = ks[-1] if ks else 0
    emit_ks = sorted(units.keys(), reverse=True)
    n_units_total = sum(len(units[K]) for K in ks)
    r_cols = np.zeros((n_units_total, cfg.r_block, kmax), np.int32)
    r_vals = np.zeros((n_units_total, cfg.r_block, kmax), np.float32)
    r_rows = np.zeros((n_units_total, cfg.r_block), np.int32)
    r_tcol = np.zeros(n_units_total, np.int32)
    r_k = np.zeros(n_units_total, np.int32)
    segments = []
    at = 0
    for K in emit_ks:
        segments.append((int(K), len(units[K])))
        for urows, tcol, ucols, uvals in units[K]:
            r_cols[at, :, :K] = ucols
            r_vals[at, :, :K] = uvals
            r_rows[at] = urows
            r_tcol[at] = tcol
            r_k[at] = K
            at += 1
    ragged = RaggedEll(cols=r_cols, vals=r_vals, rows=r_rows,
                       tile_col=r_tcol, unit_k=r_k)

    coo = CooResidual(
        rows=np.concatenate(coo_rows).astype(np.int32)
        if coo_rows else np.zeros(0, np.int32),
        cols=np.concatenate(coo_cols).astype(np.int32)
        if coo_cols else np.zeros(0, np.int32),
        vals=np.concatenate(coo_vals).astype(np.float32)
        if coo_vals else np.zeros(0, np.float32),
    )

    nnz_dense = int(sum(np.count_nonzero(b) for _, _, b in dense_tiles))
    meta = PartitionMeta(
        n_rows=n_rows, n_cols=n_cols, tile=T,
        ell_ks=tuple(ks), n_row_tiles=nrt, n_col_tiles=nct,
        n_dense_tiles=len(dense_tiles),
        nnz_dense=nnz_dense, nnz_ell=nnz_ell_real,
        nnz_ell_padded=nnz_ell_padded,
        nnz_coo=int(coo.vals.shape[0]),
        density_thresholds=(cfg.d_dense, cfg.d_scatter),
        ell_segments=tuple(segments),
    )
    part = TriPartition(dense=dt, ell=ragged, coo=coo)
    return part, meta, reports
