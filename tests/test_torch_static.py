"""The port's static analysis (``repro_torch.analysis.static``) and the
trace-report CLI (``python -m repro_torch.obs.report``).

- kernel pass: the Hopper launch-contract audit finds each hand-made
  illegal contract (``kc > w``, ``grid.y`` > 65535, ``vec`` 4 at
  F % 4 != 0, shared memory over 227 KiB or over 48 KiB without the
  opt-in, an instance outside the build, a 32-bit extent overflow, an
  out-of-range index stand-in, any spill in a canned ptxas log) and
  passes the port's own contracts, each class audited in the tuning
  applied at each width; its class-fit oracle agrees with the
  reference's;
- launch pass: clean on the fixture; a forward that calls the ragged
  wrapper twice, a kernel that drops the value mask, a host sync and a
  float64 intermediate are each caught;
- concurrency pass: clean over ``src/repro_torch`` and catching a
  seeded lock inversion against the port's declared hierarchy;
- the CLIs' exit codes, and the report CLI printing the reference's
  report for the same pipelined-simulation trace.
"""
import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.analysis.static.kernel_pass as r_kp
import repro.engine.shape_class as r_sc
import repro.obs.report as r_report
import repro.serving.simulate as r_sim
import repro_torch.obs.report as p_report
import repro_torch.serving.simulate as p_sim
from repro_torch.analysis.static import __main__ as lint_cli
from repro_torch.analysis.static.concurrency_pass import (LOCK_ORDER,
                                                          SCOPE_DIRS,
                                                          analyze_paths,
                                                          run_concurrency_pass)
from repro_torch.analysis.static.fixtures import (FIXTURE_F_HID,
                                                  FIXTURE_F_IN,
                                                  fixture_engine)
from repro_torch.analysis.static import kernel_pass
from repro_torch.analysis.static.kernel_pass import (CLAMP_F, ELL_DTYPES,
                                                     check_class_fit,
                                                     check_contract,
                                                     contracts_for_class,
                                                     heads_contracts_for_class,
                                                     run_kernel_pass)
from repro_torch.analysis.static.launch_pass import (check_sentinel_layout,
                                                     run_gat_launch_pass,
                                                     run_launch_pass)
from repro_torch.engine.shape_class import ClassNeed
from repro_torch.kernels import _build, gat_coef, ops
from repro_torch.kernels._build import mangled_args
from repro_torch.kernels.coo_spmm import (coo_rows_contract,
                                          coo_rows_heads_contract)
from repro_torch.kernels.ell_spmm import ell_contract, ragged_ell_contract
from repro_torch.kernels.tile_matmul import CONFIGS, matmul_contract

torch.set_num_threads(2)

p_ell = importlib.import_module("repro_torch.kernels.ell_spmm")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _errors(findings):
    return [f for f in findings if f.severity == "error" and not f.waived]


def _rules(findings):
    return {f.rule for f in _errors(findings)}


@pytest.fixture(scope="module")
def engine():
    return fixture_engine(device="cpu")


def _ragged(**kw):
    """A default ragged contract at a cora-like class, F = 128."""
    args = dict(g=1, u=240, r=8, kmax=8, nct=64, t=64, f=128)
    tune = kw.pop("tune", None)
    args.update(kw)
    return ragged_ell_contract(*args.values(), tune=tune)


def _stand_ins(c, **override):
    vals = {"tile_col": np.zeros(c["shapes"]["tile_col"], np.int32),
            "cols": np.zeros(c["shapes"]["cols"], np.int32),
            "unit_k": np.ones(c["shapes"].get("unit_k", (1,)), np.int32),
            "bucket_k": np.ones(c["shapes"].get("bucket_k", (1,)), np.int32)}
    vals.update(override)
    return tuple(vals[k] for k in c["index_bounds"])


def _log_for(c, stores, registers=64, loads=None):
    name = f"_ZN12_GLOBAL__N_1{len(c['kernel'])}{c['ptxas_name']}Ev"
    loads = 2 * stores if loads is None else loads
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            f"    {stores} bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads\nptxas info    : Used "
            f"{registers} registers, used 0 barriers")


class TestKernelPass:
    def test_repo_clean(self, engine):
        findings = run_kernel_pass(engine)
        assert _errors(findings) == []
        # no log on the CPU: the registers rule says so
        assert {f.rule for f in findings} == {"registers"}
        assert all("not checked" in f.message for f in findings)

    def test_default_contracts_legal(self):
        for c in (_ragged(), _ragged(f=7), _ragged(g=4),
                  ell_contract(1, 240, 8, 8, 64, 64, 128)):
            assert _errors(check_contract(
                c, scalar_args=_stand_ins(c), ptxas_log=_log_for(c, 0))) \
                == []

    def test_matmul_contracts_fit_every_configuration(self):
        for config in CONFIGS:
            c = matmul_contract(4096, 1433, 128, config=config)
            assert _errors(check_contract(c, ptxas_log=_log_for(c, 0))) == []
        wide = matmul_contract(512, 512, 512, config="wide")
        assert wide["dyn_smem"] == 4 * (64 * 20 + 16 * 128) * 4 > 48 * 1024
        assert wide["cluster"] == (1, 1, 1)
        assert matmul_contract(64, 4096, 64)["cluster"] == (1, 1, 4)

    def test_chunk_wider_than_the_row_caught(self):
        c = dict(_ragged(tune={"w": 8, "kc": 8}), kc=16,
                 instance=(8, 4, 16, 256))
        assert {"chunk", "instance"} <= _rules(
            check_contract(c, scalar_args=_stand_ins(c)))

    def test_group_over_grid_y_caught(self):
        c = _ragged(g=70000)
        assert _rules(check_contract(c, scalar_args=_stand_ins(c))) == {
            "grid"}

    def test_vec4_at_unaligned_width_caught(self):
        c = _ragged(f=7, tune={"vec": 4})
        assert c["vec"] == 1                    # the contract clamps it
        forced = dict(c, vec=4)
        assert _rules(check_contract(
            forced, scalar_args=_stand_ins(forced))) == {"vec-align"}
        unaligned = dict(_ragged(), aligned16=False)
        assert _rules(check_contract(
            unaligned, scalar_args=_stand_ins(unaligned))) == {"vec-align"}

    def test_shared_memory_over_the_block_limit_caught(self):
        c = matmul_contract(512, 512, 512, config="wide")
        assert "shared-memory" in _rules(check_contract(
            dict(c, dyn_smem=228 * 1024)))
        assert "shared-memory" in _rules(check_contract(
            dict(c, smem_optin=False)))

    def test_threads_and_cluster_limits_caught(self):
        c = _ragged()
        for bad in (dict(c, threads=2048), dict(c, threads=100)):
            assert "threads" in _rules(check_contract(
                bad, scalar_args=_stand_ins(bad)))
        m = matmul_contract(64, 4096, 64)
        assert "grid" in _rules(check_contract(dict(m, cluster=(1, 1, 16))))

    def test_instance_outside_the_build_caught(self):
        c = _ragged(tune={"w": 64})
        assert _rules(check_contract(c, scalar_args=_stand_ins(c))) == {
            "instance"}

    def test_32bit_extent_overflow_caught(self):
        c = ragged_ell_contract(2 ** 14, 2 ** 14, 8, 8, 64, 64, 32)
        assert "index-extent" in _rules(check_contract(
            c, scalar_args=(np.zeros(1, np.int32),) * 3))

    def test_out_of_range_stand_ins_caught(self):
        c = _ragged()
        bad = _stand_ins(c, tile_col=np.full(c["shapes"]["tile_col"], 64,
                                             np.int32))
        assert _rules(check_contract(c, scalar_args=bad)) == {
            "index-bounds"}
        assert _rules(check_contract(c, scalar_args=())) == {"index-bounds"}

    def test_any_spill_rejects(self):
        c = _ragged()
        for stores, loads in ((8, 16), (4, 4), (0, 8)):
            spilled = check_contract(c, scalar_args=_stand_ins(c),
                                     ptxas_log=_log_for(c, stores,
                                                        loads=loads))
            assert _rules(spilled) == {"registers"}, (stores, loads)
            assert f"reloads {loads} bytes" in _errors(spilled)[0].message
        assert check_contract(c, scalar_args=_stand_ins(c),
                              ptxas_log=_log_for(c, 0)) == []
        fat = check_contract(dict(c, threads=512), scalar_args=_stand_ins(c),
                             ptxas_log=_log_for(c, 0, registers=255))
        assert _rules(fat) == {"registers"}

    def test_instance_missing_from_the_log_caught(self):
        c = _ragged()
        other = _ragged(tune={"kc": 2})
        findings = check_contract(c, scalar_args=_stand_ins(c),
                                  ptxas_log=_log_for(other, 0))
        assert _rules(findings) == {"registers"}
        assert mangled_args((32, 4)) == "ILi32ELi4EE"

    def test_contracts_for_class_audit_the_clamped_tuning(self, engine):
        sc = engine.handle("lint-fixture").sclass
        tune = {"w": 32, "vec": 4, "kc": 8, "threads": 512}
        pairs = contracts_for_class(sc, (FIXTURE_F_IN, CLAMP_F), tune)
        ragged = [c for c, _ in pairs if c["name"] == "ragged_ell_rows"]
        n_types = len(ELL_DTYPES)
        assert [c["vec"] for c in ragged] == [4] * n_types + [1] * n_types
        assert [c["dtypes"] for c in ragged] == list(ELL_DTYPES) * 2
        # the ragged contract and the one fixed-K contract a layer, and
        # the COO row kernel's, at each width and type pair
        assert len(sc.bands) > 1 and sc.coo_nnz > 0
        coo = [c for c, _ in pairs if c["name"] == "coo_rows"]
        assert [c["dtypes"] for c in coo] == list(ELL_DTYPES) * 2
        assert len(pairs) == 2 * n_types * 2 + len(coo)
        for c, scalars in pairs:
            assert _errors(check_contract(c, scalar_args=scalars,
                                          ptxas_log=_log_for(c, 0))) == []

    def test_tuned_class_audited_in_its_applied_tuning(self, engine):
        sc = engine.handle("lint-fixture").sclass
        engine.executors.set_tuned(sc, {"w": 64})
        try:
            assert "instance" in _rules(run_kernel_pass(engine))
        finally:
            engine.executors.set_tuned(sc, {})

    def test_width_tuning_audited_at_its_width_only(self, engine):
        sc = engine.handle("lint-fixture").sclass
        engine.executors.set_tuned(sc, {"w": 64}, FIXTURE_F_HID)
        try:
            assert "instance" in _rules(run_kernel_pass(
                engine, f_widths=(FIXTURE_F_HID,)))
            assert _errors(run_kernel_pass(
                engine, f_widths=(FIXTURE_F_IN, CLAMP_F))) == []
        finally:
            engine.executors.set_tuned(sc, {})

    def test_class_fit_agrees_with_the_reference(self, engine):
        h = engine.handle("lint-fixture")
        assert check_class_fit(h.need, h.sclass) == []
        cases = [(h.need, h.sclass),
                 (dataclasses.replace(h.need, ell_units=h.sclass.ell_units
                                      + 8), h.sclass),
                 (dataclasses.replace(h.need, ell_kmax=2,
                                      ell_band_profile=((2, 4),),
                                      ell_units=4), h.sclass)]
        for need, sc in cases:
            got = check_class_fit(need, sc)
            want = r_kp.check_class_fit(
                r_sc.ClassNeed(**dataclasses.asdict(need)),
                r_sc.ShapeClass(**dataclasses.asdict(sc)))
            assert [(f.rule, f.message) for f in got] == [
                (f.rule, f.message) for f in want]
        assert isinstance(h.need, ClassNeed)


class TestGatKernelContracts:
    """The multi-head instances and the edge-coefficient kernels in the
    contract audit, as ``coo_rows`` is."""

    @pytest.mark.parametrize("h,fh", [(4, 256), (6, 41), (4, 3), (6, 16)])
    def test_heads_contracts_are_built_and_legal(self, engine, h, fh):
        sc = engine.handle("lint-fixture").sclass
        pairs = heads_contracts_for_class(sc, h, h * fh)
        assert [c["kernel"] for c, _ in pairs] == [
            "coo_rows_heads_kernel", "ell_rows_heads_kernel",
            "gat_row_stats_kernel", "gat_edge_coef_kernel"]
        for c, scalars in pairs:
            assert c["instance"][-1] == h
            assert c["ptxas_name"].endswith(f"Li{h}EE")
            assert _errors(check_contract(c, scalar_args=scalars,
                                          ptxas_log=_log_for(c, 0))) == []
        coo, ell = pairs[0][0], pairs[1][0]
        # a head of whole 16-byte rows reads 4 features a lane
        assert ell["vec"] == coo["vec"] == (4 if fh % 4 == 0 else 1)
        assert ell["shapes"]["vals"][-1] == coo["shapes"]["vals"][-1] == h

    def test_heads_contract_shared_memory_counts_the_staged_values(self):
        one = coo_rows_contract(1, 100, 64, 64, 128)
        four = coo_rows_heads_contract(1, 100, 64, 64, 128, 4)
        stage = one["static_smem"] // (4 * (one["w"] + 4))
        assert four["static_smem"] - one["static_smem"] == 4 * stage * 6

    def test_head_count_outside_the_build_caught(self):
        for c in (coo_rows_heads_contract(1, 100, 64, 64, 96, 3),
                  gat_coef.row_stats_contract(64, 3)):
            assert "instance" in _rules(check_contract(
                c, scalar_args=(np.zeros((1, 100), np.int32),)
                if c["index_bounds"] else ()))

    def test_spilling_heads_instance_rejected(self):
        c = coo_rows_heads_contract(1, 100, 64, 64, 246, 6)
        assert "registers" in _rules(check_contract(
            c, scalar_args=(np.zeros((1, 100), np.int32),),
            ptxas_log=_log_for(c, 8)))

    def test_kernel_pass_audits_the_heads_instances(self, engine,
                                                     monkeypatch):
        seen = []
        real = kernel_pass.check_contract

        def spy(c, **kw):
            seen.append(c["kernel"])
            return real(c, **kw)
        monkeypatch.setattr(kernel_pass, "check_contract", spy)
        kernel_pass.run_kernel_pass(engine)
        for k in ("ell_rows_heads_kernel", "coo_rows_heads_kernel",
                  "gat_row_stats_kernel", "gat_edge_coef_kernel"):
            assert seen.count(k) == len(_build.HEADS) * len(
                kernel_pass.HEAD_WIDTHS), k


class TestGatLaunchPass:
    def test_repo_clean(self):
        assert _errors(run_gat_launch_pass(device="cpu")) == []

    def test_double_heads_launch_caught(self, monkeypatch):
        real = ops.ell_heads_matmul

        def twice(part, coef, b, meta, plan, yd):
            real(part, coef, b, meta, plan, yd.clone())
            return real(part, coef, b, meta, plan, yd)
        monkeypatch.setattr(ops, "ell_heads_matmul", twice)
        assert "single-launch" in _rules(run_gat_launch_pass(device="cpu"))

    def test_profile_counts(self):
        from repro_torch.analysis.static import launch_pass as lp
        good = {"void gat_coef::gat_row_stats_kernel<4>": 4,
                "void gat_coef::gat_edge_coef_kernel<4>": 4,
                "void bsr_heads_kernel<Tile, true, true, 4>": 4,
                "void ragged_ell::ell_rows_heads_kernel<32, 4, 4>": 4,
                "void coo_rows::coo_rows_heads_kernel<32, 4, 1, 4>": 4}
        assert lp.check_gat_profile(good, 2, 2, True) == []
        single = dict(good, **{"ragged_ell::ell_rows_kernel<32, 4>": 1})
        assert _rules(lp.check_gat_profile(single, 2, 2, True)) == {
            "single-launch"}


class TestLaunchPass:
    def test_repo_clean(self, engine):
        assert _errors(run_launch_pass(engine)) == []

    def test_entry_points_run_on_the_card_unless_asked(self):
        import inspect
        for fn in (run_launch_pass, run_kernel_pass):
            assert inspect.signature(fn).parameters["device"].default \
                == "cuda"
        # the CPU when asked: the fixture engine is built there
        assert _errors(run_launch_pass(device="cpu")) == []
        assert _errors(run_kernel_pass(device="cpu")) == []

    def test_one_call_of_each_engine_per_layer(self, engine):
        from repro_torch.analysis.static.fixtures import fixture_x
        h = engine.handle("lint-fixture")
        fn = engine.executors.gcn(h.sclass, FIXTURE_F_IN, tuple(
            tuple(w.shape) for w in h.weights))
        x = engine.prepare_x("lint-fixture", fixture_x(h.meta.n_cols))
        ops.reset_entry_counts()
        fn(h.part, x, h.weights, h.plan)
        counts = ops.entry_counts()
        assert counts["ragged_ell_rows"] == counts["bsr_spmm_rows"] == 2
        assert not counts.get("ell_spmm_rows")

    def test_profiles_are_taken_until_two_agree(self, monkeypatch):
        """The forwards are profiled until two traces in a row hold the
        same kernel launches, not none (the profiler may lose some or all
        of a step's events), up to PROFILE_TRIES traces; when none agree
        the last trace comes back and the check runs on it."""
        from repro_torch.analysis.static import launch_pass as lp
        full = {"ell_rows_kernel<32, 4, 4, 256>": 4}
        part = {"ell_rows_kernel<32, 4, 4, 256>": 3}

        def traces(*seq):
            it = iter(seq)
            tries = []

            def once(run, calls):
                tries.append(calls)
                return next(it), {}
            monkeypatch.setattr(lp, "_profile_once", once)
            return tries

        tries = traces({}, full, full)
        assert lp.profile_forward(None, 2) == (full, {}) and len(tries) == 3
        tries = traces(part, full, full)
        assert lp.profile_forward(None, 2) == (full, {}) and len(tries) == 3
        tries = traces(*[{}] * lp.PROFILE_TRIES)
        kernels, runtime = lp.profile_forward(None, 2)
        assert kernels == {} and len(tries) == lp.PROFILE_TRIES
        assert "single-launch" in _rules(
            lp.check_profile(kernels, runtime, 2, 2, False))
        # a forward that really launches twice agrees with itself
        twice = {"ell_rows_kernel<32, 4, 4, 256>": 8}
        tries = traces(twice, twice)
        kernels, runtime = lp.profile_forward(None, 2)
        assert kernels == twice and len(tries) == 2
        assert "single-launch" in _rules(
            lp.check_profile(kernels, runtime, 2, 2, False))

    def test_double_launch_dispatch_caught(self, engine, monkeypatch):
        real = ops.ell_matmul

        def twice(part, b, meta, plan, yd, **kw):
            real(part, b, meta, plan, yd.clone(), **kw)
            return real(part, b, meta, plan, yd, **kw)
        monkeypatch.setattr(ops, "ell_matmul", twice)
        engine.executors.invalidate_class(engine.handle(
            "lint-fixture").sclass)
        findings = run_launch_pass(engine)
        assert "single-launch" in _rules(findings)

    def test_unmasked_kernel_fails_dead_lane_proof(self, engine,
                                                   monkeypatch):
        from repro_torch.core.formats import segment_sum
        from repro_torch.kernels.ref import _gather_b_tiles

        def unmasked(cols, vals, tile_col, unit_k, b_tiles, plan, out,
                     **bands):
            g, u, r, kmax = cols.shape
            f = b_tiles.shape[-1]
            bt = _gather_b_tiles(b_tiles, tile_col)
            acc = torch.zeros((g, u, r, f))
            for kk in range(kmax):
                idx = cols[..., kk].long()[..., None].expand(g, u, r, f)
                acc = acc + vals[..., kk, None] * torch.gather(bt, 2, idx)
            rows = segment_sum(acc.reshape(g * u * r, f), plan)
            return out.add_(rows.reshape(out.shape))
        monkeypatch.setattr(p_ell, "ragged_ell_rows_ref", unmasked)
        findings = run_launch_pass(engine)
        assert _rules(findings) == {"sentinel-safety"}
        assert any("masked ELL lanes" in f.message for f in findings)

    def test_host_sync_caught(self, engine, monkeypatch):
        real = ops.dense_tiles_matmul

        def syncing(part, b, meta, plan):
            float(b.sum().item())
            return real(part, b, meta, plan)
        monkeypatch.setattr(ops, "dense_tiles_matmul", syncing)
        assert "no-host-sync" in _rules(run_launch_pass(engine))

    def test_float64_intermediate_caught(self, engine, monkeypatch):
        real = ops.dense_tiles_matmul
        monkeypatch.setattr(ops, "dense_tiles_matmul",
                            lambda *a: real(*a).double().float())
        assert "dtype-flow" in _rules(run_launch_pass(engine))

    def test_sentinel_layout_caught(self, engine):
        h = engine.handle("lint-fixture")
        assert check_sentinel_layout(h) == []
        ell = h.part.ell
        vals = ell.vals.clone()
        kk = torch.arange(vals.shape[-1])
        vals[(kk >= ell.unit_k[..., None, None]).expand_as(vals)] = 1.0
        bad = dataclasses.replace(
            h, part=h.part._replace(ell=ell._replace(vals=vals)))
        assert _rules(check_sentinel_layout(bad)) == {"sentinel-safety"}


RACY_INVERSION = """\
import threading

class ExecutorCache:
    def __init__(self, engine):
        self._lock = threading.RLock()
        self.engine = engine

    def peek(self):
        with self._lock:
            self.engine.retune()

class Engine:
    def __init__(self):
        self._tune_lock = threading.Lock()
        self.executors = ExecutorCache(self)

    def retune(self):
        with self._tune_lock:
            pass

    def inspect(self):
        self.executors.peek()
"""


class TestConcurrencyPass:
    def test_repo_clean(self):
        assert _errors(run_concurrency_pass()) == []

    def test_scope_is_the_port(self):
        assert all(d.startswith("src/repro_torch/") for d in SCOPE_DIRS)
        assert {"src/repro_torch/serving", "src/repro_torch/engine",
                "src/repro_torch/obs"} <= set(SCOPE_DIRS)
        assert (LOCK_ORDER.index("Engine._tune_lock")
                < LOCK_ORDER.index("ExecutorCache._lock"))

    def test_seeded_lock_inversion_caught(self, tmp_path):
        mod = tmp_path / "inv.py"
        mod.write_text(RACY_INVERSION)
        findings = analyze_paths([mod], entry_classes={"Engine"},
                                 hints={("ExecutorCache", "engine"):
                                        "Engine"})
        assert any("inversion" in f.message and "Engine._tune_lock"
                   in f.message for f in _errors(findings))

    def test_lock_free_field_write_caught(self, tmp_path):
        mod = tmp_path / "svc.py"
        mod.write_text(textwrap.dedent("""\
            import threading

            class Svc:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.count = 0
                    self._t = threading.Thread(target=self._worker,
                                               daemon=True)

                def _worker(self):
                    self.count += 1

                def snapshot(self):
                    with self._lock:
                        return {"count": self.count}
        """))
        assert _rules(analyze_paths([mod], entry_classes={"Svc"})) == {
            "field-race"}


class TestCLIs:
    def _run(self, *args):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        return subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=300)

    def test_lint_cli_exits_clean_on_the_cpu(self):
        res = self._run("repro_torch.analysis.static", "--device", "cpu",
                        "--passes", "kernel,concurrency")
        assert res.returncode == 0, res.stdout + res.stderr
        assert "0 error(s)" in res.stdout

    def test_lint_cli_asks_for_the_card_by_default(self):
        """Without ``--device`` the launch and kernel passes run on the
        card, and without one they raise rather than fall back to the
        CPU; the concurrency pass and ``--bench-check`` need no device."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        res = self._run("repro_torch.analysis.static", "--passes", "kernel")
        assert res.returncode != 0
        assert "CUDA device requested" in res.stderr
        assert "repro_torch-lint" not in res.stdout
        for args in (("--passes", "concurrency"), ("--bench-check",)):
            res = self._run("repro_torch.analysis.static", *args)
            assert res.returncode == 0, res.stdout + res.stderr
            assert "on the host" in res.stdout

    def test_lint_cli_rejects_an_unknown_pass(self):
        assert self._run("repro_torch.analysis.static",
                         "--passes", "jaxpr").returncode == 2

    def test_lint_cli_fails_on_an_error(self, monkeypatch, capsys):
        from repro_torch.analysis.static import kernel_pass
        from repro_torch.analysis.static.report import Finding
        monkeypatch.setattr(kernel_pass, "run_kernel_pass", lambda e: [
            Finding("kernel", "grid", "error", "x", "seeded")])
        assert lint_cli.main(["--device", "cpu", "--passes", "kernel"]) == 1
        assert "seeded" in capsys.readouterr().out

    def test_report_cli_prints_the_references_report(self, tmp_path,
                                                     capsys):
        r_path, p_path = tmp_path / "r.json", tmp_path / "p.json"
        r_sim.run_pipeline_smoke(verbose=False, trace_path=str(r_path))
        p_sim.run_pipeline_smoke(verbose=False, trace_path=str(p_path))
        out_json = tmp_path / "rep.json"
        assert p_report.main([str(p_path), "--assert-complete",
                              "--json", str(out_json)]) == 0
        printed = capsys.readouterr().out.strip()
        want = r_report.format_report(r_report.report(
            r_report.load_trace(str(r_path))))
        assert printed == want
        assert json.loads(out_json.read_text())["requests"] > 0

    def test_report_cli_flags_an_incomplete_trace(self, tmp_path):
        path = tmp_path / "p.json"
        p_sim.run_pipeline_smoke(verbose=False, trace_path=str(path))
        doc = json.loads(path.read_text())
        root = next(i for i, e in enumerate(doc["traceEvents"])
                    if e.get("name") == "request")
        del doc["traceEvents"][root]
        path.write_text(json.dumps(doc))
        res = self._run("repro_torch.obs.report", str(path),
                        "--assert-complete")
        assert res.returncode == 1
        assert "INCOMPLETE TRACE" in res.stdout
