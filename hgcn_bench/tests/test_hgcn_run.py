"""Whole runs: the harness at a tiny size on the CPU (its look for a
card skipped), sound and with the timed path broken underneath; the
command's refusals; and, marked ``cuda``, one short run on the card."""
import copy
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from hgcn_bench import graphgen, spec
from hgcn_bench.cell import make_inputs, run_cell
from hgcn_bench.reference import Reference

ROOT = spec.ROOT


def _tiny(workload: str):
    """The cell as BENCHMARK.json has it, its graph cut to 600 vertices
    and 32 features and its warm-up to four requests; the open loop's
    rate raised so that batches of several requests form on the CPU."""
    cell = spec.resolve(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["graph"].update(n_vertices=600, density=0.01,
                                n_features=32)
    cell.config.pop("expected")
    t = dict(cell.traffic)
    if t["loop"] == "closed":
        t["warmup_requests"] = 4
    else:
        t.update(rate_per_s=400.0, warmup_s=0.3)
    cell.traffic = t
    return cell


def _half_batch(outs, requests, env):
    """Half of the batch left out: its members get the mean of the
    rest's outputs."""
    n = len(outs)
    if n < 2:
        return outs
    keep = outs[: n // 2]
    mean = torch.stack(keep).mean(0)
    return keep + [mean] * (n - n // 2)


def _altered(outs, requests, env):
    """One logit of each answer altered where it is produced."""
    out = []
    for y in outs:
        y = y.clone()
        y.view(-1)[y.numel() // 2] += 0.01 * float(y.abs().max())
        out.append(y)
    return out


def _tf32(outs, requests, env):
    """The control in the program's place: each answer is the TF32
    reference's logits of the request's own features, over the run's
    graph and weights (made again from the cell and the seed)."""
    if "ref" not in env:
        cell = env["cell"]
        atil, _, _ = graphgen.load_graph(cell.config["name"],
                                         cell.config["graph"],
                                         env["cache_dir"])
        env["weights"], _ = make_inputs(torch, cell.config, cell.traffic,
                                        env["seed"], atil.shape[0], "cpu")
        env["ref"] = Reference(atil, "cpu", "tf32")
    return [env["ref"].logits(x, env["weights"]).to(y.dtype)
            for (_, x), y in zip(requests, outs)]


FAULTS = {
    "unchanged": lambda outs, requests, env: [torch.zeros_like(y)
                                              for y in outs],
    "half_batch": _half_batch,
    "altered": _altered,
    "tf32": _tf32,
}


def _break(monkeypatch, fault, env) -> list:
    """Plant ``fault`` under every dispatch; returns the sizes of the
    dispatches it saw."""
    from repro_torch.engine.serving import Engine
    orig = Engine.serve_group_async
    sizes = []

    def broken(self, requests, prepared=None, **kw):
        outs, meta = orig(self, requests, prepared, **kw)
        sizes.append(len(outs))
        return FAULTS[fault](outs, requests, env), meta

    monkeypatch.setattr(Engine, "serve_group_async", broken)
    return sizes


@pytest.mark.parametrize("workload", ["reddit.batch", "reddit.online"])
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_correct_is_false_where_the_timed_path_is_broken(
        workload, fault, monkeypatch, tmp_path):
    cell, seed = _tiny(workload), 2 ** 31 + 99
    env = {"cell": cell, "seed": seed, "cache_dir": tmp_path}
    sizes = _break(monkeypatch, fault, env) if fault is not None else []
    out = run_cell(cell, seed, 2.0, False, device="cpu", cache_dir=tmp_path)
    if fault == "half_batch":
        assert max(sizes) > 1     # the fault had batches to act on
    if fault == "tf32":           # the control read above the limit
        assert out["checks"]["logit_err"]["value"] \
            > out["checks"]["logit_err"]["limit"]
    assert out["correct"] is (fault is None), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in spec.resolve(workload).end_to_end}
    assert set(out["metrics"]) == names


def test_a_traced_run_reports_the_cells_per_layer_metrics(tmp_path):
    out = run_cell(_tiny("reddit.online"), 5, 1.0, True, device="cpu",
                   cache_dir=tmp_path)
    assert out["correct"] is True
    # off the card the device readers find nothing and are left out
    assert set(out["metrics"]) == {"register_s", "queue_wait_ms.online",
                                   "mean_batch.online"}
    assert 1.0 <= out["metrics"]["mean_batch.online"]["value"] <= 4.0


def _command(cwd, workload="flickr.batch", seconds="1"):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "hgcn_bench.run", "--workload", workload,
         "--seed", "3", "--seconds", seconds, "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _command(ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr


def test_the_command_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "hgcn_bench", tmp_path / "hgcn_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    res = _command(tmp_path)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.cuda
def test_cuda_one_short_run_of_the_smallest_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = _command(ROOT, seconds="3")
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert out["metrics"]["requests_per_s.flickr"]["value"] > 0
