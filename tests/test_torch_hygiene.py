"""Boundaries of the PyTorch port.

No module of ``src/repro_torch`` and not ``chip_smoke.py`` may import
``jax`` or anything of the JAX package ``repro`` (checked on the AST, so
imports inside functions count too), and nothing may build or import a
compiler when a module is imported. ``chip_smoke.py`` must refuse to run
without a GPU or without the repository's sources: non-zero exit, and no
result line.
"""
import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys
import zipfile

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/engine/serving.py" in names
    assert "src/repro_torch/kernels/ops.py" in names
    assert "src/repro_torch/serving/frontend.py" in names
    assert "src/repro_torch/obs/trace.py" in names
    assert {"src/repro_torch/kernels/autotune.py",
            "src/repro_torch/analysis/static/kernel_pass.py",
            "src/repro_torch/analysis/static/launch_pass.py",
            "src/repro_torch/analysis/static/concurrency_pass.py",
            "src/repro_torch/analysis/static/bench_check.py",
            "src/repro_torch/analysis/static/__main__.py"} <= names
    assert {"src/repro_torch/models/common.py",
            "src/repro_torch/models/gnn.py",
            "src/repro_torch/train/optimizer.py",
            "src/repro_torch/train/steps.py",
            "src/repro_torch/tree.py",
            "src/repro_torch/core/cost_model.py",
            "src/repro_torch/data/sampler.py",
            "src/repro_torch/checkpoint/checkpoint.py",
            "src/repro_torch/distributed/fault_tolerance.py",
            "src/repro_torch/configs/__init__.py",
            "src/repro_torch/configs/base.py",
            "src/repro_torch/configs/gcn_paper.py",
            "src/repro_torch/examples/quickstart.py",
            "src/repro_torch/examples/serve_gcn.py",
            "src/repro_torch/examples/hybrid_spmm_demo.py"} <= names
    assert {"src/repro_torch/models/attention.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/models/fm.py",
            "src/repro_torch/data/tokens.py",
            "src/repro_torch/data/recsys.py",
            "src/repro_torch/examples/train_lm.py"} <= names
    assert {"src/repro_torch/models/so3.py",
            "src/repro_torch/models/dimenet.py",
            "src/repro_torch/models/nequip.py",
            "src/repro_torch/distributed/collectives.py"} <= names
    assert {"src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/elastic.py",
            "src/repro_torch/launch/local.py",
            "src/repro_torch/distributed/halo.py",
            "src/repro_torch/distributed/sharding.py",
            "src/repro_torch/models/moe_ep.py",
            "src/repro_torch/distributed/tp.py",
            "src/repro_torch/launch/specs.py"} <= names
    assert len(names) >= 20


def test_importing_the_port_builds_nothing():
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._libs and not _build.BUILD_LOG\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cuda_sources_ship_with_the_package(tmp_path):
    """A wheel of the package holds every CUDA source and every header
    the sources include: an installed port builds its kernels from them.
    The wheel is built offline (no isolation, no dependencies) from a
    copy of the package, so the checkout gets no build directory."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    assert {p.name for p in sources} >= {
        "bsr_spmm.cu", "ragged_ell_spmm.cu", "ell_spmm.cu",
        "tile_matmul.cu"}
    wanted = {p.name for p in sources}
    for p in sources + sorted(csrc.glob("*.cuh")):
        wanted |= set(re.findall(r'#include "([^"]+)"', p.read_text()))
    tree = tmp_path / "tree"
    shutil.copy(ROOT / "pyproject.toml", tmp_path)
    shutil.copytree(ROOT / "src", tmp_path / "src", ignore=(
        shutil.ignore_patterns("__pycache__", "build", "*.so", "*.egg-info")))
    res = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "--no-index", "-q", "-w", str(tree),
         str(tmp_path)], capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    (wheel,) = tree.glob("*.whl")
    with zipfile.ZipFile(wheel) as z:
        shipped = {pathlib.PurePosixPath(n).name for n in z.namelist()
                   if n.startswith("repro_torch/kernels/csrc/")}
    assert wanted <= shipped, sorted(wanted - shipped)


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_refuses_without_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "{" not in res.stdout


def test_chip_smoke_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "{" not in res.stdout
