"""The port's trajectory-file checker (``repro_torch.analysis.static
.bench_check``) against the reference's.

- the reference's own cases (``tests/test_static_analysis.py``'s
  ``TestBenchCheck``) run against the port's functions;
- the root ``BENCH_*.json`` files give the same findings (rule, severity
  and message) under both checkers, and ``python -m
  repro_torch.analysis.static --bench-check`` passes them (exit 0);
- a file the port writes passes the reference's check, and records
  ``jax_version`` "none" and the torch device as ``backend``;
- a malformed file fails both checkers, and the CLI exits 1 on it.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.analysis.static.bench_check import (PROVENANCE_KEYS,
                                                     REQUIRED_METRICS,
                                                     check_bench_file,
                                                     check_bench_files,
                                                     collect_provenance,
                                                     flatten_metrics,
                                                     write_bench_json)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROV = {"git_sha": "x", "jax_version": "y", "backend": "cpu"}
MALFORMED = [
    "not json {",
    json.dumps([1, 2]),
    # schema 1 (pre-provenance) files must fail until reseeded
    json.dumps({"bench": "b", "schema": 1, "created": "d",
                "command": "c", "metrics": {"m": 1}}),
    # schema 2 without the provenance block
    json.dumps({"bench": "b", "schema": 2, "created": "d",
                "command": "c", "metrics": {"m": 1}}),
    # provenance present but not an object
    json.dumps({"bench": "b", "schema": 2, "created": "d",
                "command": "c", "provenance": "b93d566",
                "metrics": {"m": 1}}),
    # provenance with a missing / empty / non-string key
    json.dumps({"bench": "b", "schema": 2, "created": "d", "command": "c",
                "provenance": {"git_sha": "x", "jax_version": "y"},
                "metrics": {"m": 1}}),
    json.dumps({"bench": "b", "schema": 2, "created": "d", "command": "c",
                "provenance": dict(PROV, git_sha=""), "metrics": {"m": 1}}),
    json.dumps({"bench": "b", "schema": 2, "created": "d", "command": "c",
                "provenance": dict(PROV, git_sha=7), "metrics": {"m": 1}}),
    json.dumps({"bench": "b", "schema": 2, "created": "d", "command": "c",
                "provenance": PROV, "metrics": {"m": "fast"}}),
    json.dumps({"bench": "b", "schema": 2, "created": "d", "command": "c",
                "provenance": PROV, "metrics": {"m": True}}),
    json.dumps({"schema": 2, "created": "d", "command": "c",
                "provenance": PROV, "metrics": {"m": 1}}),
]


def _errors(findings):
    return [f for f in findings if f.severity == "error" and not f.waived]


def _key(findings, root=None):
    """(rule, severity, location relative to ``root``, message) of each."""
    def loc(x):
        return os.path.relpath(x, root) if root else x
    return [(f.rule, f.severity, loc(f.location), f.message)
            for f in findings]


def test_schema_constants_are_the_references():
    from repro.analysis.static import bench_check as ref

    assert PROVENANCE_KEYS == ref.PROVENANCE_KEYS
    assert REQUIRED_METRICS == ref.REQUIRED_METRICS


def test_flatten():
    flat = flatten_metrics({"a": {"ms": 1.5, "ok": True, "note": "x"},
                            "n": 3})
    assert flat == {"a.ms": 1.5, "n": 3}


def test_roundtrip_is_clean(tmp_path):
    path = tmp_path / "BENCH_test.json"
    write_bench_json(path, "bench_test", "bench_test --smoke",
                     "2026-08-08", {"cora": {"ms": 2.0}})
    assert check_bench_file(path) == []
    assert check_bench_files(tmp_path) == []


@pytest.mark.parametrize("doc", MALFORMED)
def test_malformed_files_fail_as_under_the_reference(tmp_path, doc):
    from repro.analysis.static.bench_check import check_bench_file as ref

    path = tmp_path / "BENCH_bad.json"
    path.write_text(doc)
    got = check_bench_file(path)
    assert _errors(got)
    assert _key(got) == _key(ref(path))


def test_provenance_collected_automatically(tmp_path):
    path = tmp_path / "BENCH_test.json"
    doc = write_bench_json(path, "bench_test", "bench_test --smoke",
                           "2026-08-08", {"ms": 1.0})
    prov = doc["provenance"]
    assert set(prov) == {"git_sha", "jax_version", "backend"}
    assert all(isinstance(v, str) and v for v in prov.values())
    assert prov["jax_version"] == "none" and prov["backend"] == "cpu"
    assert collect_provenance("cuda")["backend"] == "cuda"


def test_required_metrics_enforced(tmp_path):
    path = tmp_path / "BENCH_spmm.json"
    write_bench_json(path, "bench_spmm", "bench_spmm --smoke", "2026-08-08",
                     {"cora": {"launches_per_spmm": 1,
                               "ell_pad_waste_x": 6.0}})
    (finding,) = _errors(check_bench_file(path))
    assert "achieved_roofline_frac" in finding.message
    write_bench_json(path, "bench_spmm", "bench_spmm --smoke", "2026-08-08",
                     {"cora": {"launches_per_spmm": 1,
                               "ell_pad_waste_x": 6.0,
                               "achieved_roofline_frac": 0.004}})
    assert check_bench_file(path) == []


def test_required_metrics_scoped_to_bench(tmp_path):
    path = tmp_path / "BENCH_other.json"
    write_bench_json(path, "bench_other", "bench_other", "2026-08-08",
                     {"ms": 1.0})
    assert check_bench_file(path) == []


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        ROOT.glob("BENCH_*.json")))
def test_root_files_give_the_references_findings(name):
    from repro.analysis.static.bench_check import check_bench_file as ref

    path = ROOT / name
    assert _key(check_bench_file(path)) == _key(ref(path))
    assert _errors(check_bench_file(path)) == []


def test_root_files_give_the_references_findings_as_a_set():
    from repro.analysis.static.bench_check import check_bench_files as ref

    assert _key(check_bench_files(ROOT), ROOT) == _key(ref(ROOT), ROOT)


def test_port_written_file_passes_the_references_check(tmp_path):
    from repro.analysis.static.bench_check import check_bench_file as ref

    path = tmp_path / "BENCH_spmm.json"
    write_bench_json(path, "bench_spmm", "bench_spmm --smoke", "2026-08-08",
                     {"cora": {"launches_per_spmm": 1,
                               "ell_pad_waste_x": 6.0,
                               "achieved_roofline_frac": 0.004}},
                     backend="cuda")
    assert ref(path) == [] and check_bench_file(path) == []


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis.static",
                           *args], env=env, capture_output=True, text=True,
                          timeout=120)


def test_cli_bench_check(tmp_path):
    ok = _cli("--bench-check")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "passes bench" in ok.stdout
    (tmp_path / "BENCH_bad.json").write_text(MALFORMED[2])
    bad = _cli("--bench-check", str(tmp_path))
    assert bad.returncode == 1
    assert "trajectory-schema" in bad.stdout
