"""The ragged ELL kernel at any number of K bands, and ``max_bands`` as a
tunable.

The reference's ``merge_bands`` / ``_bands_of`` and its Pallas
``ragged_ell_spmm`` take any ``max_bands`` from 1 up. Held against it on
the CPU:

- the port's plain ``ragged_ell_spmm`` against the reference's
  ``ragged_ell_spmm(..., gu=1, interpret=True)`` at ``max_bands`` 5, 6, 8
  and 64, on the synthetic runs of ``test_torch_ell_kband.py`` and on a
  small labels-reordered cora, within the tolerance of
  ``test_banded_ref_matches_the_pallas_kernel_at_finite_b``; with the
  same NaN and inf masks where B is non-finite at a lane inside or past
  a band;
- ``_bands_of`` / ``_band_tables`` equal to the reference's at those
  counts.

Within the port: bit for bit the same result at every ``max_bands``
from 1 to 64 at finite B; ``max_bands`` below 1 raises; the launch
contract and the kernel pass take and describe a plan of 23 bands (the
[U] band table); the band table kept on its device; ``max_bands`` in the
tuned launch (``resolve_tune``, ``ops.ell_matmul``, ``Engine.autotune``
with an injected timer); the autotuner's candidates, their dedup on the
class's band plan, and a cache entry written without ``max_bands``
missing.

The table mode on the card (more than 4 bands, at every launch shape and
both types) is tested by ``test_torch_ell_rows.py``'s ``cuda`` tests:
this file runs the reference's kernel, which needs JAX, and the card's
machine has no JAX.
"""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.analysis.static.kernel_pass import (check_bands,
                                                     check_contract)
from repro_torch.engine import Engine
from repro_torch.engine.shape_class import ShapeClass
from repro_torch.kernels import bands as kb
from repro_torch.kernels.autotune import (SWEEP_MAX_BANDS, Autotuner,
                                          candidates)
from repro_torch.kernels.ell_spmm import (LAUNCH_KEYS, band_cap, band_table,
                                          contract_cost, ragged_ell_contract,
                                          ragged_ell_spmm, resolve_tune)
from repro_torch.kernels.ref import ragged_ell_spmm_ref

from conftest import make_heterogeneous_matrix
from test_torch_ell_kband import (KERNEL_TOL, SYNTH_RUNS, _labels_partition,
                                  _pallas, _poison, assert_same_bits, synth)

torch.set_num_threads(2)

ref_ell = importlib.import_module("repro.kernels.ell_spmm")
ell = importlib.import_module("repro_torch.kernels.ell_spmm")

MANY = (5, 6, 8, 64)
# a descending plan of 23 K runs, as cora@labels' training partition has
RUNS_23 = tuple((k, 1 + k % 3) for k in range(47, 0, -2))[:23]


def _labels_units():
    """cora at 0.3 reordered by labels, unpadded: 13 K runs."""
    part, meta = _labels_partition("cora", 0.3)
    e = part.ell
    return (*(torch.as_tensor(np.asarray(x)) for x in (
        e.cols, e.vals, e.tile_col, e.unit_k)), meta)


LABELS = _labels_units()


# ----------------------------------------------- against the reference ----
@pytest.mark.parametrize("max_bands", MANY)
@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_runs_match_the_pallas_kernel(seed, max_bands):
    cols, vals, tcol, unit_k, b, runs = synth(seed)
    got = ragged_ell_spmm(cols, vals, tcol, unit_k, b, segments=runs,
                          max_bands=max_bands, device="cpu")
    want = _pallas(cols, vals, tcol, unit_k, b, runs, max_bands)
    torch.testing.assert_close(got, want, **KERNEL_TOL)
    assert torch.equal(got, ragged_ell_spmm_ref(
        cols, vals, tcol, unit_k, b, segments=runs, max_bands=max_bands))


@pytest.mark.parametrize("max_bands", MANY)
def test_labels_graph_matches_the_pallas_kernel(max_bands):
    cols, vals, tcol, unit_k, meta = LABELS
    segs = meta.ell_segments
    assert len(segs) > 8
    b = torch.from_numpy(np.random.default_rng(max_bands).standard_normal(
        (meta.n_col_tiles, meta.tile, 5)).astype(np.float32))
    got = ragged_ell_spmm(cols, vals, tcol, unit_k, b, segments=segs,
                          max_bands=max_bands, device="cpu")
    want = _pallas(cols, vals, tcol, unit_k, b, segs, max_bands)
    torch.testing.assert_close(got, want, **KERNEL_TOL)


@pytest.mark.parametrize("max_bands", MANY)
def test_band_table_equals_the_references_past_four(max_bands):
    cases = [(SYNTH_RUNS, 14, 9), (RUNS_23, sum(n for _, n in RUNS_23), 47),
             (RUNS_23, sum(n for _, n in RUNS_23), 30),
             (LABELS[-1].ell_segments, LABELS[0].shape[0],
              LABELS[0].shape[-1])]
    for segments, u, kmax in cases:
        mine = kb._bands_of(segments, u, kmax, max_bands)
        want = ref_ell._bands_of(segments, u, kmax, max_bands)
        assert mine == want
        assert kb._band_tables(mine) == ref_ell._band_tables(want)
        assert len(mine) == min(max_bands, len(
            kb.merge_bands(tuple((min(k, kmax), n) for k, n in segments),
                           10 ** 6)))


@pytest.mark.parametrize("where", ["inside", "past"])
@pytest.mark.parametrize("max_bands", [5, 8])
def test_nonfinite_masks_past_four_bands(max_bands, where):
    cols, vals, tcol, unit_k, b, runs = synth(3)
    cols[cols == b.shape[1] - 1] = 0
    unit = _poison(cols, tcol, unit_k, b, runs, max_bands, where)
    got = ragged_ell_spmm(cols, vals, tcol, unit_k, b, segments=runs,
                          max_bands=max_bands, device="cpu")
    want = _pallas(cols, vals, tcol, unit_k, b, runs, max_bands)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], **KERNEL_TOL)
    assert bool(torch.isnan(got[unit, 0]).any()) == (where == "inside")


# ------------------------------------------------------------ within ----
@pytest.mark.parametrize("g", [None, 2])
def test_every_band_count_gives_the_same_bits_at_finite_b(g):
    cols, vals, tcol, unit_k, b, runs = synth(7, g=g)
    want = ragged_ell_spmm(cols, vals, tcol, unit_k, b, device="cpu")
    for mb in range(1, 65):
        assert_same_bits(ragged_ell_spmm(
            cols, vals, tcol, unit_k, b, segments=runs, max_bands=mb,
            device="cpu"), want)


def test_rows_at_every_band_count_on_the_labels_graph(monkeypatch):
    """``hybrid_spmm`` over the unpadded labels partition (its 13 runs,
    as training runs them) through ``ops.ell_matmul``: the same bits at
    every cap, which reaches the kernel from ``ell_tune``."""
    part, meta = _labels_partition("cora", 0.3)
    b = np.random.default_rng(5).standard_normal((meta.n_cols, 6)).astype(
        np.float32)
    want = tc.hybrid_spmm(part, b, meta=meta, device="cpu")
    seen = []
    real = ell.ragged_ell_rows

    def spy(*a, max_bands=None, **kw):
        seen.append(max_bands)
        return real(*a, max_bands=max_bands, **kw)
    monkeypatch.setattr(ell, "ragged_ell_rows", spy)
    for mb in (1, 4, 5, 13, 64):
        assert_same_bits(tc.hybrid_spmm(
            part, b, meta=meta, ell_tune={"max_bands": mb}, device="cpu"),
            want)
    assert seen == [1, 4, 5, 13, 64]


def test_max_bands_below_one_and_a_conflict_raise():
    cols, vals, tcol, unit_k, b, runs = synth(0)
    for mb in (0, -1):
        with pytest.raises(ValueError, match="max_bands"):
            ragged_ell_spmm_ref(cols, vals, tcol, unit_k, b, segments=runs,
                                max_bands=mb)
        with pytest.raises(ValueError, match="max_bands"):
            ragged_ell_spmm(cols, vals, tcol, unit_k, b, segments=runs,
                            tune={"max_bands": mb}, device="cpu")
    with pytest.raises(ValueError, match="max_bands"):
        band_cap(5, {"max_bands": 4})
    assert band_cap() == kb.DEFAULT_MAX_BANDS
    assert band_cap(None, {"max_bands": 9}) == band_cap(9, {"max_bands": 9})
    assert resolve_tune(8, {"max_bands": 0})["max_bands"] == 0  # audit's


def test_band_table_is_the_unit_bounds_kept_per_plan():
    bands = kb._bands_of(RUNS_23, sum(n for _, n in RUNS_23), 47, 64)
    assert len(bands) == 23 and kb.band_mode(bands) == "table"
    t = band_table(bands, "cpu")
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), kb.unit_bounds(bands))
    assert band_table(bands, "cpu") is t
    assert kb.band_mode(bands[:4]) == "value"


# ------------------------------------------------- contract and audit ----
def test_contract_describes_a_23_band_plan():
    u = sum(n for _, n in RUNS_23)
    shape = (1, u, 4, 47, 3, 64, 128)
    c = ragged_ell_contract(*shape, segments=RUNS_23, max_bands=64)
    assert c["bands"] == RUNS_23 and c["max_bands"] == 64
    assert c["band_mode"] == "table"
    assert c["kernel"] == "ell_rows_table_kernel"
    assert c["ptxas_name"].startswith("ell_rows_table_kernel")
    assert c["shapes"]["band_k"] == (u,)
    assert check_bands(c) == []
    tile_col = np.full((1, u), 2, np.int32)
    cols = np.full((1, u, 4, 47), 63, np.int32)
    unit_k = kb.unit_bounds(RUNS_23)[None]
    found = check_contract(c, scalar_args=(tile_col, cols, unit_k),
                           ptxas_log="")
    assert [(f.rule, f.severity) for f in found] == [("registers", "warn")]
    four = ragged_ell_contract(*shape, segments=RUNS_23)
    assert four["band_mode"] == "value" and len(four["bands"]) == 4
    assert four["kernel"] == "ell_rows_kernel" and "band_k" not in four[
        "shapes"]
    # the table's bytes: 4 a unit, beside the value mode's counts
    assert contract_cost(dict(four, band_mode="table"))["hbm_bytes"] == \
        contract_cost(four)["hbm_bytes"] + 4 * u


@pytest.mark.parametrize("edit,rule", [
    (dict(kernel="ell_rows_kernel"), "by value"),
    (dict(kernel="ell_rows_table_kernel", shapes=None), "one entry a unit"),
    (dict(max_bands=0), "1 or more"),
])
def test_kernel_pass_rejects_a_bad_table_mode(edit, rule):
    u = sum(n for _, n in RUNS_23)
    c = ragged_ell_contract(1, u, 4, 47, 3, 64, 128, segments=RUNS_23,
                            max_bands=64)
    if edit.get("shapes", 1) is None:
        edit = dict(edit, shapes={k: v for k, v in c["shapes"].items()
                                  if k != "band_k"})
    found = check_bands(dict(c, **edit))
    assert found and all(f.rule == "bands" and f.severity == "error"
                         for f in found)
    assert any(rule in f.message for f in found)


def test_an_illegal_tuned_cap_goes_to_the_audit():
    c = ragged_ell_contract(1, 14, 4, 9, 3, 16, 8, segments=SYNTH_RUNS,
                            tune={"max_bands": 0})
    assert c["max_bands"] == 0
    assert any("max_bands=0" in f.message for f in check_bands(c))
    with pytest.raises(ValueError, match="max_bands"):
        ragged_ell_contract(1, 14, 4, 9, 3, 16, 8, segments=SYNTH_RUNS,
                            max_bands=0)


# ------------------------------------------------------------ autotune ----
ONE_BAND = ShapeClass(tile=64, n_row_tiles=2, n_col_tiles=2, n_dense_tiles=0,
                      ell_kmax=16, ell_units=24, coo_nnz=0, r_block=8)
FOUR_BANDS = dataclasses.replace(ONE_BAND, ell_bands=(
    (16, 4), (8, 8), (4, 8), (2, 4)))


@pytest.mark.parametrize("f", (7, 128))
def test_candidates_sweep_the_cap_deduplicated_on_the_class(f):
    shapes = 54 if f % 4 == 0 else 27
    for sc, n in ((ONE_BAND, shapes), (FOUR_BANDS, 2 * shapes)):
        cands = candidates(f, sc.bands)
        assert len(cands) == n
        assert cands[0] == resolve_tune(f)
        assert {c["max_bands"] for c in cands} == set(
            SWEEP_MAX_BANDS[:len(cands) // shapes])
        eff = {(tuple(resolve_tune(f, c)[k] for k in LAUNCH_KEYS),
                kb.merge_bands(sc.bands, c["max_bands"])) for c in cands}
        assert len(eff) == len(cands)
    assert len(candidates(f)) == len(SWEEP_MAX_BANDS) * shapes
    assert SWEEP_MAX_BANDS == (4, 1)


def test_a_cache_entry_without_max_bands_misses(tmp_path):
    path = tmp_path / "tune.json"
    old = {"w": 8, "vec": 1, "kc": 2, "threads": 128}
    key = f"cpu|cpu|{FOUR_BANDS.summary()}|f=32"          # the older key
    path.write_text(json.dumps({key: {"config": old, "ms": 1e-3}}))
    t = Autotuner(str(path), timer=lambda cfg: 1.0, device="cpu")
    cfg = t.tune(FOUR_BANDS, 32)
    assert (t.misses, t.hits) == (1, 0) and t.timed == t.swept
    assert cfg == resolve_tune(32) and cfg["max_bands"] == 4
    assert len(json.loads(path.read_text())) == 2


def test_engine_autotune_carries_max_bands_to_the_kernel(monkeypatch):
    """A timer that favours one band: the winner ``{"max_bands": 1, ...}``
    lands in the class's tuning and reaches ``ragged_ell_rows`` through
    ``ell_tune``; ``infer`` keeps its bits."""
    rng = np.random.default_rng(0)
    eng = Engine(device="cpu")
    eng.register("g0", tc.csr_from_dense(make_heterogeneous_matrix(
        300, seed=0)), weights=[
            (rng.standard_normal((16, 8)) * 0.1).astype(np.float32),
            (rng.standard_normal((8, 4)) * 0.1).astype(np.float32)])
    sc = eng.handle("g0").sclass
    assert len(sc.bands) > 1
    x = rng.standard_normal((300, 16)).astype(np.float32)
    y0 = eng.infer("g0", x)
    log = []

    def timer(cfg):
        log.append(dict(cfg))
        return 1.0 if cfg["max_bands"] == 4 else 0.5
    cfg = eng.autotune("g0", 8, timer=timer)
    assert cfg == dict(resolve_tune(8), max_bands=1)
    assert {c["max_bands"] for c in log} == {4, 1}
    assert eng.executors.tuned_for(sc, 8) == cfg
    rows = eng.autotuner.last_sweep
    assert {r["bands"] for r in rows} == {len(sc.bands), 1}
    seen = []
    real = ell.ragged_ell_rows

    def spy(*a, max_bands=None, tune=None, **kw):
        seen.append((int(a[4].shape[-1]), max_bands, dict(tune or {})))
        return real(*a, max_bands=max_bands, tune=tune, **kw)
    monkeypatch.setattr(ell, "ragged_ell_rows", spy)
    y = eng.infer("g0", x)
    assert torch.equal(y, y0)
    assert seen[0] == (8, 1, cfg)
    assert seen[1][:2] == (4, kb.DEFAULT_MAX_BANDS)   # layer 2: untuned
