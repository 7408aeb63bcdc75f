"""BENCHMARK.json against the benchmark's contract, and every cell
resolving to its configuration, traffic and metric files."""
import json
import re

import pytest

from hgcn_bench import spec, traffic

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hgcn_bench"]
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entries_have_exactly_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hgcn_bench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        limit = 0.25
        assert 0.01 <= m["bound"] <= limit
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_names_units_and_uniqueness():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]


def test_shares_are_named_as_the_contract_asks():
    for m in BENCH["per_layer"]:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_to_its_files(workload):
    cell = spec.resolve(workload)
    traffic.check(cell.traffic)
    assert cell.config["name"] == cell.workload["config"]
    assert "logit_err" in cell.config["limits"]
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load_reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_every_config_is_used_and_states_its_source():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["assumed"]
        assert cfg["model"]["dtype"] == "float32"
        assert cfg["model"]["tf32"] is False
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_moves_names_an_end_to_end_metric_of_each_listed_cell():
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            e2e, _ = spec.metrics_of(BENCH, w)
            assert m["moves"] in [e["name"] for e in e2e], (m["name"], w)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
