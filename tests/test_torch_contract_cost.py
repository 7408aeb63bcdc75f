"""``kernels.ell_spmm.contract_cost``: the HBM bytes and FMA operations of
one launch of the ELL row kernels, against counts made by hand.

One member, two units of two rows, Kmax = 2, B of two 4-row tiles, F =
3. Unit rows (entries) 0, 2 and 3 are summed (0 and 2 onto padded row 0,
3 onto row 2; entry 1 is in no plan); their lanes address 4 distinct B
rows. Bytes: cols and vals of each lane a summed entry's chain reads
(one Kmax band: 3·2·8; bands or buckets (2, 1), (1, 1): unit 0 reads 2
lanes, unit 1 one, (2 + 1 + 1)·8), tile_col and unit_k (ragged) or
bucket_k (fixed K) of the 2 units reached, the 8-byte order entries
(3·8), the index of the 2 live rows (offsets 0-3 read and 2 live-table
entries, (4 + 2)·8), the distinct B rows those lanes address (4·3·4),
each live row read and written (2·3·8). Operations: 2·F per lane read,
F per entry onto its row's sum, F per live row.
"""
import numpy as np
import torch

from repro_torch.core.formats import SegmentPlan
from repro_torch.kernels.ell_spmm import (contract_cost, ell_contract,
                                          ragged_ell_contract)

G, U, R, K, NCT, T, F = 1, 2, 2, 2, 2, 4, 3
COLS = torch.tensor([[[[0, 1], [1, 3]], [[2, 2], [0, 0]]]],
                    dtype=torch.int32)
TILE_COL = torch.tensor([[0, 1]], dtype=torch.int32)
ORDER = torch.tensor([0, 2, 3])


def _long(x):
    return torch.tensor(x, dtype=torch.int64)


PLAN = SegmentPlan(order=ORDER, lengths=_long([2, 0, 1]), n_entries=4,
                   offsets=_long([0, 2, 2, 3]), live=_long([[0, 2]]))
RUNS = ((2, 1), (1, 1))


def test_ragged_launch_by_hand():
    c = ragged_ell_contract(G, U, R, K, NCT, T, F, n_slots=2)
    got = contract_cost(c, cols=COLS, tile_col=TILE_COL, plan=PLAN)
    assert got == {"hbm_bytes": 48 + 2 * 8 + 24 + 6 * 8 + 48 + 48.0,
                   "flops": 36 + 9 + 6.0}


def test_ragged_launch_reads_only_its_band_lanes():
    """With bands (2, 1), (1, 1) unit 1's entries read one lane each."""
    c = ragged_ell_contract(G, U, R, K, NCT, T, F, segments=RUNS,
                            n_slots=2)
    assert c["bands"] == RUNS and c["band_offs"] == (1,)
    got = contract_cost(c, cols=COLS, tile_col=TILE_COL, plan=PLAN)
    assert got == {"hbm_bytes": 32 + 2 * 8 + 24 + 6 * 8 + 48 + 48.0,
                   "flops": 24 + 9 + 6.0}


def test_band_launch_by_hand_and_across_a_layer():
    """The fixed-K launch covers the layer's buckets: each unit reads its
    bucket's K lanes; one Kmax bucket without segments."""
    c = ell_contract(G, U, R, K, NCT, T, F, segments=RUNS, n_slots=2)
    assert c["bands"] == RUNS and c["shapes"]["bucket_k"] == (U,)
    got = contract_cost(c, cols=COLS, tile_col=TILE_COL, plan=PLAN)
    assert got == {"hbm_bytes": 32 + 2 * 8 + 24 + 6 * 8 + 48 + 48.0,
                   "flops": 24 + 9 + 6.0}
    whole = ell_contract(G, U, R, K, NCT, T, F, n_slots=2)
    assert whole["bands"] == ((K, U),)
    assert contract_cost(whole, cols=COLS, tile_col=TILE_COL, plan=PLAN) \
        == contract_cost(ragged_ell_contract(G, U, R, K, NCT, T, F,
                                             n_slots=2),
                         cols=COLS, tile_col=TILE_COL, plan=PLAN)


def test_shapes_only_is_the_most_the_shapes_allow():
    c = ragged_ell_contract(G, U, R, K, NCT, T, F, n_slots=2)
    got = contract_cost(c)
    # 4 entries, 2 units, 2 live rows, all 8 B rows, offsets + live table
    assert got == {"hbm_bytes": 64 + 16 + 32 + 5 * 8 + 96 + 48.0,
                   "flops": 48 + 12 + 6.0}
    data = contract_cost(c, cols=COLS, tile_col=TILE_COL, plan=PLAN)
    assert data["hbm_bytes"] <= got["hbm_bytes"]
    assert data["flops"] <= got["flops"]
    assert np.isfinite(got["hbm_bytes"])
