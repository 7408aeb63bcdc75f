"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each metric is a
reader of its own, and each configuration names its model. Their files
sit at fixed places under the benchmark's folder, so a later cell,
metric or model is a new file and a new entry, never an edit:

  configurations  the ``file`` of the ``configs`` entry
  traffic mixes   ``traffic/<traffic>.json``
  metric readers  ``metrics/<metric name>.py``, each with ``read(ctx)``;
                  ``<base>.<qualifier>`` with no file of its own is read
                  by ``<base>``'s (the same quantity in cells that
                  report another end-to-end metric)
  models          ``models/<kind>.py``, ``kind`` the configuration's
                  ``model.kind``

A model module provides

  ``make_inputs(torch, config, traffic, seed, n, device)``
      ``(weights, pool)``: the weights in any structure the module
      defines, and the feature pool ``[snapshots, n, f_in]`` float32,
      both made on the device from the seed;
  ``register(engine, name, csr, graph, labels, weights)``
      the program's ``Engine.register`` called with what the model
      needs (``csr`` the program's CSR of A_tilde, ``graph`` the
      configuration's graph block); returns the handle;
  ``reference(csr, device, precision)``
      an object with ``logits(x, weights)``: the plain forward over the
      benchmark's scipy CSR, ``precision`` "float64" (the reference) or
      "tf32" (the control); it imports nothing of the program or JAX;
  ``request_flops(config, n, nnz)``
      the model FLOPs of one request on the unpadded graph;

and optionally ``layer1_operands(engine, name, handle, x)``, layer 1's
X·W operands as the executor gets them, which the ``xw_ms`` and
``spmm_ms`` readers time (without it they read nothing).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# where ``load_model`` looks; a module constant, so a test can point it
# at a directory of its own
MODELS_DIR = BENCH_DIR / "models"
# the reader and model modules loaded so far, by path
_LOADED: dict = {}


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
    """``metrics/<metric>.py``; a metric ``<base>.<qualifier>`` with no
    file of its own is ``<base>`` read in other cells, by
    ``metrics/<base>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.is_file() and "." in metric:
        return BENCH_DIR / "metrics" / f"{metric.split('.')[0]}.py"
    return path


def model_path(kind: str) -> Path:
    return Path(MODELS_DIR) / f"{kind}.py"


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


def _load_file(prefix: str, name: str, path: Path):
    """The module at ``path``, loaded once a process; FileNotFoundError
    naming the path where there is none."""
    key = str(path)
    if key not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no {prefix} {path} for {name!r}")
        mod_name = f"hgcn_bench_{prefix}_" + name.replace(".", "_").replace(
            "-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


def load_reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _load_file("metric", metric, reader_path(metric)).read


def load_model(kind: str):
    """The module ``models/<kind>.py`` (``kind`` a ``model.kind``)."""
    return _load_file("model", kind, model_path(kind))


def model_of(config: dict):
    """The model module of a configuration (its ``model.kind``)."""
    return load_model(config["model"]["kind"])
