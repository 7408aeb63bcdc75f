"""K bands of the ragged ELL unit array: the port's copy of the
reference's band helpers (``repro.kernels.ell_spmm.merge_bands``,
``_bands_of``, ``_band_tables``, ``DEFAULT_MAX_BANDS``).

Units arrive sorted by K descending; ``segments`` (a partition's
``ell_segments``) carries their (K, n_units) runs. The ragged kernel and
its plain version merge the runs to at most ``max_bands`` bands (any
count from 1 up, as the reference takes it) and run each unit's chain
only up to its band's K, as the TPU kernel ``_ragged_ell_kernel`` does:
lanes in [band K, Kmax) are never read. The port's shape classes plan
their band slots with the same helpers.

The CUDA kernel takes a plan of at most ``VALUE_BANDS`` bands by value
(``band_mode`` "value") and a longer one as a [U] table of each unit's
band K (``unit_bounds``, mode "table").
"""
from __future__ import annotations

import numpy as np

# Band-merge cap (the reference's default), and the most bands the
# ragged kernel receives by value; a plan of more goes as a [U] table.
DEFAULT_MAX_BANDS = 4
VALUE_BANDS = 4


def merge_bands(runs, max_bands: int) -> tuple:
    """Merge descending-K (K, n_units) runs down to ``max_bands`` bands.

    Adjacent runs merge into the wider K; the pair chosen at each step
    is the one adding the least padded-MAC waste
    ``(K_left - K_right) * n_right``. Deterministic (first minimum
    wins), returns a tuple of (K, n_units) with K strictly descending.
    """
    merged: list = []
    for k, n in runs:
        if n <= 0:
            continue
        if merged and merged[-1][0] == int(k):
            merged[-1][1] += int(n)
        else:
            merged.append([int(k), int(n)])
    while len(merged) > max_bands:
        best = min(range(len(merged) - 1),
                   key=lambda i: (merged[i][0] - merged[i + 1][0])
                   * merged[i + 1][1])
        merged[best][1] += merged[best + 1][1]
        del merged[best + 1]
    return tuple((k, n) for k, n in merged)


def _bands_of(segments, u: int, kmax: int, max_bands: int) -> tuple:
    """Normalize ``segments`` into a K-descending band plan.

    Empty segments (or any non-descending order) collapse to one
    Kmax-wide band; band Ks are clamped to the slab width.
    """
    if u == 0:
        return ()
    segs = tuple((int(k), int(n)) for k, n in segments if int(n) > 0)
    if not segs or sum(n for _, n in segs) != u:
        return ((kmax, u),)
    ks = [k for k, _ in segs]
    if any(ks[i] < ks[i + 1] for i in range(len(ks) - 1)):
        return ((kmax, u),)
    segs = tuple((min(k, kmax), n) for k, n in segs)
    return merge_bands(segs, max_bands)


def _band_tables(bands) -> tuple:
    """(band_ks, band_counts, band_offs) of a band plan; ``band_offs``
    holds the starting unit index of every band past the first, so unit
    u's band is ``sum(u >= off)``."""
    band_ks = tuple(k for k, _ in bands)
    band_counts = tuple(n for _, n in bands)
    offs, at = [], 0
    for _, n in bands[:-1]:
        at += n
        offs.append(at)
    return band_ks, band_counts, tuple(offs)


def check_max_bands(max_bands: int) -> int:
    """``max_bands`` as the reference's ``merge_bands`` takes it: any
    count from 1 up (at 0 or below its merge has no pair to choose)."""
    if int(max_bands) < 1:
        raise ValueError(f"max_bands={max_bands}: the ragged ELL kernel "
                         "takes 1 or more K bands")
    return int(max_bands)


def band_mode(bands) -> str:
    """How the ragged kernel takes the band plan ``bands``: "value" (at
    most ``VALUE_BANDS`` bands, ``ell_rows::Bands``) or "table" (a [U]
    int32 of each unit's band K on the card)."""
    return "value" if len(bands) <= VALUE_BANDS else "table"


def unit_bounds(bands) -> np.ndarray:
    """[U] int32: the K of each unit's band (or bucket), the lanes its
    chain runs over."""
    return np.repeat([k for k, _ in bands],
                     [n for _, n in bands]).astype(np.int32)
