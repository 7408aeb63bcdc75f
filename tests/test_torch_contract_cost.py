"""``kernels.ell_spmm.contract_cost``: the HBM bytes and FMA operations of
one launch of the ELL row kernels, against counts made by hand.

One member, two units of two rows, K = 2, B of two 4-row tiles, F = 3.
Unit rows (entries) 0, 2 and 3 are summed (0 and 2 onto padded row 0, 3
onto row 2; entry 1 is in no plan); their lanes address 4 distinct B
rows. Bytes: cols and vals of every lane of each summed entry (3·2·8),
tile_col (and unit_k, ragged) of the 2 units reached, the 8-byte order
entries (3·8), the index of the 2 live rows (ragged: offsets 0-3 read
and 2 live-table entries, (4 + 2)·8; fixed K: offset, row and carry
entries, (3·2 + 1)·8), the B rows (4·3·4), each live row read and
written (2·3·8) and, fixed K, one carried row (3·4). Operations: 2·K·F
per entry, F per entry onto its row's sum, F per live row.
"""
import numpy as np
import torch

from repro_torch.core.formats import BandPlan, SegmentPlan
from repro_torch.kernels.ell_spmm import (contract_cost, ell_contract,
                                          ragged_ell_contract)

G, U, R, K, NCT, T, F = 1, 2, 2, 2, 2, 4, 3
COLS = torch.tensor([[[[0, 1], [1, 3]], [[2, 2], [0, 0]]]],
                    dtype=torch.int32)
TILE_COL = torch.tensor([[0, 1]], dtype=torch.int32)
ORDER = torch.tensor([0, 2, 3])


def _long(x):
    return torch.tensor(x, dtype=torch.int64)


def test_ragged_launch_by_hand():
    plan = SegmentPlan(order=ORDER, lengths=_long([2, 0, 1]), n_entries=4,
                       offsets=_long([0, 2, 2, 3]), live=_long([[0, 2]]))
    c = ragged_ell_contract(G, U, R, K, NCT, T, F, n_slots=2)
    got = contract_cost(c, cols=COLS, tile_col=TILE_COL, plan=plan)
    assert got == {"hbm_bytes": 48 + 2 * 8 + 24 + 6 * 8 + 48 + 48.0,
                   "flops": 36 + 9 + 6.0}


def test_band_launch_by_hand_and_across_a_layer():
    band = BandPlan(order=ORDER, offsets=_long([0, 2, 3]),
                    rows=_long([[0, 2]]), carry=_long([[-1, 5]]), n_carry=2)
    c = ell_contract(G, U, R, K, NCT, T, F, n_slots=2)
    one = contract_cost(c, cols=COLS, tile_col=TILE_COL, plan=band)
    assert one == {"hbm_bytes": 48 + 2 * 4 + 24 + 7 * 8 + 48 + 48 + 12.0,
                   "flops": 36 + 9 + 6.0}
    # a second launch of the same layer over the same rows: its B rows and
    # output rows were counted by the first
    seen = {}
    first = contract_cost(c, cols=COLS, tile_col=TILE_COL, plan=band,
                          seen=seen)
    second = contract_cost(c, cols=COLS, tile_col=TILE_COL, plan=band,
                           seen=seen)
    assert first == one
    assert second == {"hbm_bytes": 48 + 2 * 4 + 24 + 7 * 8 + 12.0,
                      "flops": 36 + 9.0}


def test_shapes_only_is_the_most_the_shapes_allow():
    c = ragged_ell_contract(G, U, R, K, NCT, T, F, n_slots=2)
    got = contract_cost(c)
    # 4 entries, 2 units, 2 live rows, all 8 B rows, offsets + live table
    assert got == {"hbm_bytes": 64 + 16 + 32 + 5 * 8 + 96 + 48.0,
                   "flops": 48 + 12 + 6.0}
    plan = SegmentPlan(order=ORDER, lengths=_long([2, 0, 1]), n_entries=4,
                       offsets=_long([0, 2, 2, 3]), live=_long([[0, 2]]))
    data = contract_cost(c, cols=COLS, tile_col=TILE_COL, plan=plan)
    assert data["hbm_bytes"] <= got["hbm_bytes"]
    assert data["flops"] <= got["flops"]
    assert np.isfinite(got["hbm_bytes"])
