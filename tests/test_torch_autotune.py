"""The port's contract-checked ragged-kernel autotuner.

Mirrors ``tests/test_autotune.py`` for ``repro_torch.kernels.autotune``:
determinism (same sweep -> same winner, cached winners survive process
restarts), economy (a cache hit never re-sweeps, no-ELL classes short
circuit, candidates deduplicated on the clamped launch shape) and safety
(a candidate the Hopper contract audit rejects is NEVER timed). The
audit's registers rule reads the build's ptxas log, which the CPU has
not got: tests that need a rejection hand the audit a canned log of the
54 instances in ptxas's own format, where any spill rejects.

Then the engine: ``Engine.autotune`` with an injected timer applies the
winner to its class at its width (each layer runs its own width's),
invalidates only that class's executors (in every replica view too),
keeps ``infer`` bitwise, and ``stats()["autotune"]`` carries the
reference's keys; and the parity with the reference's tuner (cache file
format, stats keys, the class part of the key).

Tests marked ``cuda`` run every legal candidate on the card.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

import repro.engine.shape_class as r_sc
import repro.kernels.autotune as r_at
from repro_torch.core import csr_from_dense
from repro_torch.engine import Engine
from repro_torch.engine.shape_class import ShapeClass
from repro_torch.kernels import _build
from repro_torch.kernels.autotune import (SWEEP_MAX_BANDS, AutotuneCache,
                                          Autotuner, candidates,
                                          class_stand_ins)
from repro_torch.kernels.ell_spmm import (LAUNCH_KEYS, TUNE_KC, TUNE_KEYS,
                                          TUNE_THREADS, TUNE_VEC, TUNE_W,
                                          resolve_tune)
from repro_torch.obs.trace import Tracer

from conftest import make_heterogeneous_matrix

torch.set_num_threads(2)

SMALL = ShapeClass(tile=64, n_row_tiles=2, n_col_tiles=2, n_dense_tiles=0,
                   ell_kmax=16, ell_units=24, coo_nnz=0, r_block=8,
                   ell_bands=((16, 8), (8, 16)))
NO_ELL = ShapeClass(tile=64, n_row_tiles=2, n_col_tiles=2, n_dense_tiles=4,
                    ell_kmax=0, ell_units=0, coo_nnz=0, r_block=8)
# a class whose unit rows overflow the kernels' 32-bit numbering: every
# candidate is illegal
HUGE = ShapeClass(tile=64, n_row_tiles=2, n_col_tiles=2, n_dense_tiles=0,
                  ell_kmax=1, ell_units=2 ** 28, coo_nnz=0, r_block=8)


def _timer(log=None):
    """Deterministic injectable timer: unique seconds per config."""
    def timer(cfg):
        if log is not None:
            log.append(dict(cfg))
        return (cfg["w"] * 1e-6 + cfg["vec"] * 1e-5 + cfg["kc"] * 1e-7
                + cfg["threads"] * 1e-10)
    return timer


def _boom(cfg):
    raise AssertionError("timer must not be called")


def _ptxas_log(spills=lambda inst: 0) -> str:
    """A ptxas -v log of every ragged-kernel instance, in ptxas's own
    format; ``spills(instance)`` gives each one's spill-store bytes."""
    lines = []
    for inst in itertools.product(TUNE_W, TUNE_VEC, TUNE_KC, TUNE_THREADS):
        name = ("_ZN10ragged_ell15ell_rows_kernel"
                + "I" + "".join(f"Li{v}E" for v in inst) + "ffE"
                + "EvN8ell_rows5UnitsIT3_EEPKT4_PKxSB_SB_Pfiiii")
        sp = spills(inst)
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  "'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    {sp} bytes stack frame, {sp} bytes spill stores, "
                  f"{2 * sp} bytes spill loads",
                  "ptxas info    : Used 64 registers, used 0 barriers"]
    return "\n".join(lines)


@pytest.fixture
def ptxas_log(monkeypatch):
    """Install a canned build log for the ragged kernel."""
    def install(spills):
        monkeypatch.setitem(_build.BUILD_LOG, "ragged_ell_spmm",
                            {"path": "", "seconds": 0.0, "cached": True,
                             "log": _ptxas_log(spills)})
    return install


def _tuner(timer=None, path=None):
    return Autotuner(path, timer=timer, device="cpu")


class TestDeterminism:
    def test_same_sweep_same_winner(self):
        w1 = _tuner(_timer()).tune(SMALL, 32)
        w2 = _tuner(_timer()).tune(SMALL, 32)
        assert w1 == w2
        assert set(w1) == set(TUNE_KEYS)

    def test_cache_hit_skips_resweep(self, tmp_path):
        path = str(tmp_path / "tune.json")
        t1 = _tuner(_timer(), path)
        w1 = t1.tune(SMALL, 32)
        assert (t1.misses, t1.hits) == (1, 0) and t1.timed > 0
        assert t1.tune(SMALL, 32) == w1          # same tuner: in memory
        assert (t1.misses, t1.hits) == (1, 1)
        t2 = _tuner(_boom, path)                 # same disk cache
        assert t2.tune(SMALL, 32) == w1
        assert (t2.misses, t2.hits, t2.timed) == (0, 1, 0)
        assert len(t2.cache) == 1

    def test_key_embeds_device_class_and_width(self):
        t = _tuner(_timer())
        k = t.cache_key(SMALL, 32)
        assert k == (f"cpu[w,vec,kc,threads,max_bands]|cpu|"
                     f"{SMALL.summary()}|f=32")
        assert k != f"cpu|cpu|{SMALL.summary()}|f=32", \
            "a key written without max_bands must miss"
        assert k != t.cache_key(SMALL, 64)
        rebanded = dataclasses.replace(SMALL, ell_bands=())
        assert k != t.cache_key(rebanded, 32), \
            "a band-plan change must miss, not serve a stale winner"

    def test_unreadable_cache_treated_as_empty(self, tmp_path):
        path = tmp_path / "tune.json"
        path.write_text("{not json")
        t = _tuner(_timer(), str(path))
        assert t.tune(SMALL, 32) == _tuner(_timer()).tune(SMALL, 32)
        assert json.loads(path.read_text())       # rewritten whole

    def test_ties_keep_the_default(self):
        assert _tuner(lambda cfg: 1.0).tune(SMALL, 128) == resolve_tune(128)


class TestCandidates:
    @pytest.mark.parametrize("f", (3, 7, 8, 16, 32, 48, 128))
    def test_default_first_and_unique_on_clamped_config(self, f):
        cands = candidates(f)
        assert cands[0] == resolve_tune(f)
        eff = [tuple(resolve_tune(f, c).values()) for c in cands]
        assert len(eff) == len(set(eff))
        assert len(cands) == len(SWEEP_MAX_BANDS) * (54 if f % 4 == 0
                                                     else 27)

    def test_vec4_clamps_where_rows_do_not_allow_it(self):
        cfg = {"w": 32, "vec": 4, "kc": 4, "threads": 256}
        assert resolve_tune(7, cfg)["vec"] == 1
        assert resolve_tune(128, cfg, aligned=False)["vec"] == 1
        assert resolve_tune(128, cfg)["vec"] == 4

    def test_unknown_knob_raises(self):
        with pytest.raises(ValueError, match="knob"):
            resolve_tune(32, {"bf": 64})


class TestOracleGate:
    def test_rejected_candidates_never_timed(self, ptxas_log):
        # the instances that spill (here: every kc = 8)
        ptxas_log(lambda inst: 32 if inst[2] == 8 else 0)
        log = []
        t = _tuner(_timer(log))
        t.tune(SMALL, 128)
        assert t.rejected == sum(c["kc"] == 8 for c in candidates(128)) > 0
        assert t.timed == len(log)
        legal = [c for c in candidates(128)
                 if not any(x.severity == "error"
                            for x in t._audit(SMALL, 128, c))]
        assert log == legal, \
            "timed set must be exactly the audit-legal set, in order"
        assert all(c["kc"] != 8 for c in log)
        rows = {tuple(r["config"].values()): r for r in t.last_sweep}
        assert all((r["ms"] is None) == (r["config"]["kc"] == 8)
                   for r in rows.values())

    def test_a_spilling_default_is_rejected_too(self, ptxas_log):
        default = tuple(resolve_tune(128)[k] for k in LAUNCH_KEYS)
        ptxas_log(lambda inst: 8 if inst == default else 0)
        log = []
        t = _tuner(_timer(log))
        findings = t._audit(SMALL, 128, resolve_tune(128))
        assert [(x.rule, x.severity) for x in findings] == [
            ("registers", "error")]
        winner = t.tune(SMALL, 128)
        # the default launch shape at each swept band cap (SMALL has two
        # bands, so both caps are candidates of their own)
        assert t.rejected == len(SWEEP_MAX_BANDS)
        assert all(tuple(c[k] for k in LAUNCH_KEYS) != default for c in log)
        assert winner and tuple(winner[k] for k in LAUNCH_KEYS) != default

    def test_without_a_log_registers_are_not_checked(self, monkeypatch):
        monkeypatch.delitem(_build.BUILD_LOG, "ragged_ell_spmm",
                            raising=False)
        findings = _tuner()._audit(SMALL, 32, resolve_tune(32))
        assert [(x.rule, x.severity) for x in findings] == [
            ("registers", "warn")]
        assert "not checked" in findings[0].message

    def test_small_class_times_everything(self):
        log = []
        t = _tuner(_timer(log))
        t.tune(SMALL, 32)
        assert t.rejected == 0
        assert t.swept == t.timed == len(log) == len(candidates(32))

    def test_no_ell_class_short_circuits(self):
        t = _tuner(_boom)
        assert t.tune(NO_ELL, 32) == {}
        assert (t.swept, t.timed, len(t.cache)) == (0, 0, 0)

    def test_every_candidate_illegal_gives_defaults(self, monkeypatch):
        monkeypatch.setattr("repro_torch.kernels.autotune.class_stand_ins",
                            lambda sc: (np.zeros((1, 1), np.int32),) * 3)
        t = _tuner(_boom)
        assert t.tune(HUGE, 32) == {}
        assert t.rejected == t.swept == len(candidates(32, HUGE.bands))
        assert t.timed == 0

    def test_default_timer_needs_a_card(self):
        with pytest.raises(RuntimeError, match="CUDA"):
            _tuner().tune(SMALL, 32)

    def test_sweep_lands_on_the_trace(self):
        t = _tuner(_timer())
        t.tracer = Tracer()
        t.tune(SMALL, 32)
        t.tune(SMALL, 32)
        ev = [e for e in t.tracer.events() if e["name"] == "autotune.sweep"]
        assert [e["args"]["cached"] for e in ev] == [False, True]


def _engine(tmp_path=None):
    rng = np.random.default_rng(0)
    eng = Engine(device="cpu", autotune_cache=(
        None if tmp_path is None else str(tmp_path / "tune.json")))
    ws = [(rng.standard_normal((16, 8)) * 0.1).astype(np.float32),
          (rng.standard_normal((8, 4)) * 0.1).astype(np.float32)]
    eng.register("g0", csr_from_dense(make_heterogeneous_matrix(300, seed=0)),
                 weights=ws)
    eng.register("g1", csr_from_dense(make_heterogeneous_matrix(700, seed=1)),
                 weights=ws)
    return eng, rng


class TestEngineIntegration:
    def test_engine_autotune_bitwise_and_stats(self, tmp_path):
        eng, rng = _engine(tmp_path)
        x = rng.standard_normal((300, 16)).astype(np.float32)
        y0 = eng.infer("g0", x)
        cfg = eng.autotune("g0", 8, timer=_timer())   # layer 1's width
        assert set(cfg) == set(TUNE_KEYS) and cfg != resolve_tune(8)
        sc = eng.handle("g0").sclass
        assert eng.executors.tuned_for(sc, 8) == cfg
        assert torch.equal(eng.infer("g0", x), y0)
        s = eng.stats()["autotune"]
        assert s["misses"] == 1 and s["cache_entries"] == 1
        assert s["timed"] + s["rejected"] == s["swept"]
        eng.autotune("g0", 8)                   # same (class, width): a hit
        assert eng.stats()["autotune"]["hits"] == 1

    def test_autotune_invalidates_only_that_class(self):
        eng, rng = _engine()
        sc0, sc1 = (eng.handle(n).sclass for n in ("g0", "g1"))
        assert sc0 != sc1
        for name, n in (("g0", 300), ("g1", 700)):
            eng.infer(name, rng.standard_normal((n, 16)).astype(np.float32))
        eng.autotune("g0", 8, timer=_timer())
        per = eng.executors.class_stats()
        assert per[sc0.summary()]["invalidations"] == 1
        assert per[sc1.summary()]["invalidations"] == 0
        assert eng.executors.tuned_for(sc1, 8) == {}

    def test_replica_views_see_the_engines_tuning(self):
        eng, rng = _engine()
        before = eng.replica_view(0)
        cfg = eng.autotune("g0", 8, timer=_timer())
        after = eng.replica_view(1)
        sc = eng.handle("g0").sclass
        assert before.executors.tuned_for(sc, 8) == cfg
        assert after.executors.tuned_for(sc, 8) == cfg
        x = rng.standard_normal((300, 16)).astype(np.float32)
        assert torch.equal(before.serve_group([("g0", x)])[0],
                           eng.infer("g0", x))

    def test_set_tuned_is_idempotent(self):
        eng, rng = _engine()
        sc = eng.handle("g0").sclass
        eng.infer("g0", rng.standard_normal((300, 16)).astype(np.float32))
        cfg = resolve_tune(16)
        assert eng.executors.set_tuned(sc, cfg) == 1
        assert eng.executors.set_tuned(sc, cfg) == 0
        assert eng.executors.set_tuned(sc, {}) == 0   # nothing rebuilt yet
        assert eng.executors.tuned_for(sc) == {}

    def test_each_width_runs_its_own_winner(self, monkeypatch):
        from repro_torch.kernels import ops
        eng, rng = _engine()
        sc = eng.handle("g0").sclass
        # weights 16 -> 8 -> 4: the ragged launches run at F = 8 and 4
        hid = eng.autotune("g0", 8, timer=_timer())
        out = eng.autotune("g0", 4, timer=lambda cfg: (
            -cfg["threads"] - cfg["kc"] * 1e-3 - cfg["w"] * 1e-6))
        assert hid != out
        assert eng.executors.tuned_for(sc, 8) == hid
        assert eng.executors.tuned_for(sc, 4) == out
        assert eng.executors.tuned_for(sc) == {}     # none for every width
        assert eng.executors.tuned() == {sc: {8: hid, 4: out}}
        seen = []
        real = ops.ell_matmul

        def spy(part, b, *a, ell_tune=None, **kw):
            seen.append((int(b.shape[-1]), ell_tune))
            return real(part, b, *a, ell_tune=ell_tune, **kw)
        monkeypatch.setattr(ops, "ell_matmul", spy)
        eng.infer("g0", rng.standard_normal((300, 16)).astype(np.float32))
        assert seen == [(8, hid), (4, out)]
        view = eng.replica_view(0)
        assert view.executors.tuned() == eng.executors.tuned()

    def test_set_tuned_for_every_width_replaces_the_widths(self):
        eng, _ = _engine()
        sc = eng.handle("g0").sclass
        a, b = resolve_tune(8), dict(resolve_tune(8), threads=512)
        eng.executors.set_tuned(sc, a, 8)
        eng.executors.set_tuned(sc, b)
        assert eng.executors.tuned_for(sc) == b
        assert eng.executors.tuned_for(sc, 8) == b   # the width's is gone
        assert eng.executors.tuned_for(sc, 4) == b
        eng.executors.set_tuned(sc, a, 8)
        assert (eng.executors.tuned_for(sc, 8),
                eng.executors.tuned_for(sc, 4)) == (a, b)

    def test_tuner_follows_the_engine_tracer(self):
        eng, _ = _engine()
        eng.autotune("g0", 16, timer=_timer())
        tracer = Tracer()
        eng.attach_tracer(tracer)
        assert eng.autotuner.tracer is tracer


class TestParity:
    """The port's tuner against the reference's, the same injected timer
    (one number per call, whatever the knobs)."""

    def _pair(self, tmp_path):
        r_small = r_sc.ShapeClass(**dataclasses.asdict(SMALL))
        calls = iter(range(10 ** 6))
        timer = lambda cfg: 1.0 + next(calls) * 1e-6   # first min wins
        rt = r_at.Autotuner(str(tmp_path / "r.json"), timer=timer,
                            backend="cpu")
        pt = Autotuner(str(tmp_path / "p.json"), timer=timer, device="cpu")
        return rt, pt, r_small

    def test_cache_file_format_and_stats_keys_match(self, tmp_path):
        rt, pt, r_small = self._pair(tmp_path)
        rw, pw = rt.tune(r_small, 32), pt.tune(SMALL, 32)
        rdoc = json.loads((tmp_path / "r.json").read_text())
        pdoc = json.loads((tmp_path / "p.json").read_text())
        (rk, rv), = rdoc.items()
        (pk, pv) = next(iter(pdoc.items()))
        assert set(rv) == set(pv) == {"config", "ms"}
        assert rv["config"] == rw and pv["config"] == pw
        assert type(rv["ms"]) is type(pv["ms"]) is float
        assert set(rt.stats()) == set(pt.stats())
        assert {k: type(v) for k, v in rt.stats().items()} == {
            k: type(v) for k, v in pt.stats().items()}
        # the class and width parts of the key are the reference's
        assert pk.split("|", 2)[2] == rk.split("|", 1)[1]

    def test_both_keep_the_first_candidate_on_ties(self, tmp_path):
        rt, pt, r_small = self._pair(tmp_path)
        assert rt.tune(r_small, 128) == r_at.candidates(128)[0]
        assert pt.tune(SMALL, 128) == candidates(128)[0]


def test_member_operands_are_the_members_launch():
    from repro_torch.kernels.autotune import member_operands
    from repro_torch.kernels.ell_spmm import ragged_ell_rows
    eng, _ = _engine()
    h = eng.handle("g0")
    data = member_operands(h.part, h.host_plan, h.sclass, 8, "cpu")
    cols, vals, tile_col, unit_k, b, plan, out = data
    e = h.part.ell
    assert torch.equal(cols[0], e.cols) and torch.equal(vals[0], e.vals)
    assert tuple(b.shape) == (1, h.sclass.n_col_tiles, h.sclass.tile, 8)
    assert out.shape[:2] == (1, plan.lengths.shape[0]) and not out.any()
    y = ragged_ell_rows(*data[:6], out.clone(), device="cpu")
    assert torch.equal(y, ragged_ell_rows(*data[:6], out.clone(),
                                          tune=candidates(8)[-1],
                                          device="cpu"))


def test_stand_ins_are_worst_case():
    tile_col, cols, unit_k = class_stand_ins(SMALL)
    assert (tile_col == SMALL.n_col_tiles - 1).all()
    assert (cols == SMALL.tile - 1).all()
    assert unit_k.tolist() == [[16] * 8 + [8] * 16]


# --------------------------------------------------------------- card -----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("f", (128, 7))
def test_every_legal_candidate_bitwise_on_card(card, f):
    from repro_torch.core.formats import b_tiles_of, plan_to, stack_plans
    from repro_torch.data.graphs import make_paper_dataset
    from repro_torch.kernels.ell_spmm import ragged_ell_rows
    rng = np.random.default_rng(0)
    csr, _, _, _ = make_paper_dataset("cora", scale=1.0, seed=0)
    eng = Engine(device="cuda")
    eng.register("cora", csr)
    h = eng.handle("cora")
    meta = h.sclass.to_meta()
    b = torch.from_numpy(rng.standard_normal(
        (meta.n_cols, f)).astype(np.float32)).cuda()
    bt = b_tiles_of(b[None], meta).contiguous()
    plan = plan_to(stack_plans([h.host_plan]), "cuda").ell
    e = h.part.ell
    args = (e.cols[None], e.vals[None], e.tile_col[None], e.unit_k[None],
            bt, plan)
    yd = torch.from_numpy(rng.standard_normal(
        (1, meta.n_padded_rows, f)).astype(np.float32)).cuda()
    want = ragged_ell_rows(*args, yd.clone())
    t = Autotuner(timer=lambda cfg: 1.0)
    t.tune(h.sclass, f)
    legal = [r["config"] for r in t.last_sweep if r["ms"] is not None]
    assert legal
    for cfg in legal:
        assert torch.equal(ragged_ell_rows(*args, yd.clone(), tune=cfg),
                           want), cfg


@pytest.mark.cuda
def test_default_timer_times_the_device(card):
    eng = Engine(device="cuda")
    eng.register("g0", csr_from_dense(make_heterogeneous_matrix(700,
                                                                seed=1)))
    sc = eng.handle("g0").sclass
    with pytest.raises(ValueError, match="operands"):
        Autotuner().tune(sc, 32)      # no member's rows to time
    cfg = eng.autotune("g0", 32)
    t = eng.autotuner
    ms = [r["ms"] for r in t.last_sweep if r["ms"] is not None]
    assert cfg and ms and all(0 < m < 1.0 for m in ms)
    assert t.timed == len(ms)
