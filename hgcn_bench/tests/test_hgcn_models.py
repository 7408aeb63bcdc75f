"""Models behind ``spec.load_model``: the GCN's module gives what the
harness computed before it had one, bit for bit; a second kind joins
through a module file, a configuration and entries alone; a kind with no
module is refused with the path looked for."""
import json
import math
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from hgcn_bench import control, graphgen, spec, yardstick
from hgcn_bench.cell import Context, Session, make_inputs, run_cell
from hgcn_bench.reference import csr_tensor, logit_err, round_tf32
from hgcn_bench.tests.test_hgcn_run import _tiny

ROOT = spec.ROOT
CONFIGS = {"reddit.batch": "gcn-reddit", "flickr.batch": "gcn-flickr"}
INTERFACE = ("make_inputs", "register", "reference", "request_flops")


def _parent_inputs(config, traffic, seed, n):
    """The weights and pool as the harness made them before models had
    modules: glorot layers [F, H] ... [H, C], then the Bernoulli pool,
    all from one generator seeded with the run's seed."""
    graph, model = config["graph"], config["model"]
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    dims = [graph["n_features"]] + [model["d_hidden"]] * (
        model["n_layers"] - 1) + [graph["n_classes"]]
    weights = []
    for a, b in zip(dims[:-1], dims[1:]):
        lim = math.sqrt(6.0 / (a + b))
        u = torch.rand((a, b), generator=gen, dtype=torch.float32)
        weights.append(u * (2.0 * lim) - lim)
    pool = torch.empty((traffic["snapshots"], n, graph["n_features"]))
    for s in range(traffic["snapshots"]):
        torch.lt(torch.rand((n, graph["n_features"]), generator=gen),
                 traffic["feature_density"], out=pool[s])
    return weights, pool


def _parent_logits(atil, x, weights, precision):
    """``A_tilde · relu(A_tilde · X · W1) · W2`` with the parent's
    operations: float64 throughout, or TF32-rounded operands with
    float32 sums (the control)."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    op = (lambda t: t.to(dtype)) if precision == "float64" \
        else (lambda t: round_tf32(t.to(dtype)))
    data = np.asarray(atil.data)
    if precision == "tf32":
        data = round_tf32(torch.as_tensor(data, dtype=torch.float32)).numpy()
    a = csr_tensor(atil.indptr, atil.indices, data, atil.shape, "cpu", dtype)
    h = x
    for i, w in enumerate(weights):
        h = torch.sparse.mm(a, op(torch.matmul(op(h), op(w))))
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


@pytest.mark.parametrize("workload", sorted(CONFIGS))
def test_the_gcn_module_gives_the_parents_inputs_and_reference(
        workload, tmp_path):
    cell, seed = _tiny(workload), 2 ** 31 + 17
    model = spec.model_of(cell.config)
    assert model is spec.load_model("gcn")
    atil, _, _ = graphgen.load_graph(cell.config["name"],
                                     cell.config["graph"], tmp_path)
    n = atil.shape[0]
    weights, pool = model.make_inputs(torch, cell.config, cell.traffic, seed,
                                      n, "cpu")
    want_w, want_pool = _parent_inputs(cell.config, cell.traffic, seed, n)
    assert len(weights) == len(want_w)
    assert all(torch.equal(a, b) for a, b in zip(weights, want_w))
    assert torch.equal(pool, want_pool)
    # the name the harness had keeps giving the same
    w2, pool2 = make_inputs(torch, cell.config, cell.traffic, seed, n, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(w2, want_w))
    assert torch.equal(pool2, want_pool)
    for precision in ("float64", "tf32"):
        got = model.reference(atil, "cpu", precision).logits(pool[0],
                                                             weights)
        want = _parent_logits(atil, pool[0], want_w, precision)
        assert torch.equal(got, want), precision


@pytest.mark.parametrize("workload", sorted(CONFIGS))
def test_the_control_reads_what_the_parents_formulas_give(workload,
                                                          tmp_path):
    cell = _tiny(workload)
    rows = control.readings(cell, [1, 2], device="cpu", cache_dir=tmp_path)
    atil, _, _ = graphgen.load_graph(cell.config["name"],
                                     cell.config["graph"], tmp_path)
    for seed, row in zip([1, 2], rows):
        weights, pool = _parent_inputs(cell.config, cell.traffic, seed,
                                       atil.shape[0])
        worst = max(logit_err(_parent_logits(atil, x, weights, "tf32"),
                              _parent_logits(atil, x, weights, "float64"))
                    for x in pool)
        assert row["seed"] == seed and row["control_logit_err"] == worst
        assert row["control_logit_err"] > row["limit"]


@pytest.mark.parametrize("config", sorted(CONFIGS.values()))
def test_request_flops_is_the_yardsticks(config):
    with open(ROOT / "hgcn_bench" / "configs" / f"{config}.json") as f:
        cfg = json.load(f)
    g, m = cfg["graph"], cfg["model"]
    n, nnz = g["n_vertices"], cfg["expected"]["nnz_a_tilde"]
    assert spec.model_of(cfg).request_flops(cfg, n, nnz) == \
        yardstick.gcn_request_flops(n, nnz, g["n_features"], m["d_hidden"],
                                    g["n_classes"])


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "models").glob(
    "*.py")), ids=lambda p: p.stem)
def test_every_model_module_provides_the_interface(path):
    mod = spec.load_model(path.stem)
    for name in INTERFACE:
        assert callable(getattr(mod, name, None)), (path.stem, name)


def test_every_configuration_names_a_model_module():
    for c in spec.load_benchmark()["configs"]:
        with open(ROOT / c["file"]) as f:
            kind = json.load(f)["model"]["kind"]
        assert spec.model_path(kind).is_file(), kind


def test_a_kind_with_no_module_names_the_path_it_looked_for():
    with pytest.raises(FileNotFoundError) as err:
        spec.load_model("no-such-model")
    assert str(spec.MODELS_DIR / "no-such-model.py") in str(err.value)


# a second model kind, written where the test points spec.MODELS_DIR:
# SGC with one propagation step (Wu et al., arXiv:1902.07153),
# logits = A_tilde · X · W, served as a one-layer weight list
SGC = textwrap.dedent('''
    """SGC, K = 1: logits = A_tilde · X · W."""
    import torch

    from hgcn_bench.reference import csr_tensor, round_tf32


    def make_inputs(torch, config, traffic, seed, n, device):
        from hgcn_bench.traffic import feature_pool
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        f, c = config["graph"]["n_features"], config["graph"]["n_classes"]
        w = torch.rand((f, c), generator=gen, device=device) - 0.5
        return w, feature_pool(torch, gen, traffic, n, f, device)


    def register(engine, name, csr, graph, labels, weights):
        return engine.register(name, csr, reorder=graph["reorder"],
                               labels=labels, weights=[weights])


    class _Ref:
        def __init__(self, csr, device, precision):
            self.dtype = torch.float64 if precision == "float64" \\
                else torch.float32
            self.op = (lambda t: t) if precision == "float64" \\
                else round_tf32
            self.a = csr_tensor(csr.indptr, csr.indices, csr.data,
                                csr.shape, device, self.dtype)

        def logits(self, x, w):
            xw = self.op(x.to(self.dtype)) @ self.op(w.to(self.dtype))
            return torch.sparse.mm(self.a, self.op(xw))


    def reference(csr, device, precision="float64"):
        return _Ref(csr, device, precision)


    def request_flops(config, n, nnz):
        c = config["graph"]["n_classes"]
        return 2.0 * n * config["graph"]["n_features"] * c + 2.0 * nnz * c
''')


def _second_kind(tmp_path, monkeypatch):
    """A copy of BENCHMARK.json beside the module file, with a new
    configuration of kind ``sgc``, a workload of it and its name
    appended to ``requests_per_s``'s cells. No harness file changes."""
    models = tmp_path / "models"
    models.mkdir()
    (models / "sgc.py").write_text(SGC)
    monkeypatch.setattr(spec, "MODELS_DIR", models)
    bench = spec.load_benchmark()
    cfg_file = "hgcn_bench/configs/sgc-tiny.json"
    (tmp_path / "hgcn_bench" / "configs").mkdir(parents=True)
    (tmp_path / cfg_file).write_text(json.dumps({
        "name": "sgc-tiny", "source": "https://arxiv.org/abs/1902.07153",
        "model": {"kind": "sgc", "dtype": "float32", "tf32": False},
        "graph": {"dataset": "tiny", "n_vertices": 600, "density": 0.01,
                  "n_features": 32, "n_classes": 5, "generator": "sbm",
                  "graph_seed": 0, "fill": False, "reorder": "labels"},
        "limits": {"logit_err": 4e-05}, "assumed": ["a test's own"]}))
    bench["configs"].append({"name": "sgc-tiny", "source": "test",
                             "file": cfg_file, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "sgc.batch", "config": "sgc-tiny",
                               "traffic": "batch", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "requests_per_s":
            m["workloads"].append("sgc.batch")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec.resolve("sgc.batch", tmp_path)


def test_a_second_model_kind_runs_through_run_cell(tmp_path, monkeypatch):
    cell = _second_kind(tmp_path, monkeypatch)
    assert [m["name"] for m in cell.end_to_end] == ["requests_per_s",
                                                    "setup_s"]
    assert cell.per_layer == []
    out = run_cell(cell, 2 ** 31 + 5, 1.0, False, device="cpu",
                   cache_dir=tmp_path)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"requests_per_s", "setup_s"}
    assert out["checks"]["compared"]["value"] >= 1


def test_a_model_without_layer1_operands_gives_the_readers_nothing(
        tmp_path, monkeypatch):
    gcn = _tiny("flickr.batch")
    sess = Session(gcn.config, gcn.traffic, 3, "cpu", cache_dir=tmp_path)
    x, w = Context(gcn, sess, None, 0.0).layer1_operands()
    assert x.shape[0] == 1 and x.shape[2] == 32
    assert torch.equal(w[0], sess.handle.weights[0])
    cell = _second_kind(tmp_path, monkeypatch)
    sess = Session(cell.config, cell.traffic, 3, "cpu", cache_dir=tmp_path)
    assert Context(cell, sess, None, 0.0).layer1_operands() is None


def test_the_command_refuses_an_unknown_kind(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "hgcn_bench", tmp_path / "hgcn_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    path = tmp_path / "hgcn_bench" / "configs" / "gcn-flickr.json"
    cfg = json.loads(path.read_text())
    cfg["model"]["kind"] = "gcn-typo"
    path.write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "hgcn_bench.run", "--workload", "flickr.batch",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 2 and res.stdout == ""
    assert str(tmp_path / "hgcn_bench" / "models" / "gcn-typo.py") \
        in res.stderr
