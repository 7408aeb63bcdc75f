"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each metric is a
reader of its own. Their files sit at fixed places under the
benchmark's folder, so a later cell or metric is a new file and a new
entry, never an edit:

  configurations  the ``file`` of the ``configs`` entry
  traffic mixes   ``traffic/<traffic>.json``
  metric readers  ``metrics/<metric name>.py``, each with ``read(ctx)``
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list      # the metric entries this cell reports untraced
    per_layer: list       # ... and traced

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def traffic_path(traffic: str) -> Path:
    return BENCH_DIR / "traffic" / f"{traffic}.json"


def reader_path(metric: str) -> Path:
    return BENCH_DIR / "metrics" / f"{metric}.py"


def metrics_of(bench: dict, workload: str) -> tuple:
    """(end-to-end entries, per-layer entries) that cell ``workload``
    reports. An end-to-end metric without ``workloads`` is every cell's.
    A per-layer one without ``workloads`` is reported wherever the
    end-to-end metric it moves is."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The ``Cell`` of ``workload``; KeyError naming what is missing."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(Path(root) / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"])) as f:
        traffic = json.load(f)
    e2e, per = metrics_of(bench, workload)
    return Cell(workload=w, config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per)


def load_reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = reader_path(metric)
    mod_name = "hgcn_bench_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
