"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and a run
refuses to print a result where one was loaded."""
import ast
import pathlib
import sys

import pytest

from hgcn_bench import run

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(BENCH_DIR.rglob("*.py"))


def _tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = set(_tops(path)) & {"jax", "jaxlib", "flax", "repro"}
    assert not bad, f"{path} imports {bad}"


def test_forbidden_modules_compares_whole_names():
    names = ["repro_torch", "repro_torch.engine", "jaxtyping", "hgcn_bench"]
    assert run.forbidden_modules(names) == []
    assert run.forbidden_modules(names + ["repro.core"]) == ["repro"]
    assert run.forbidden_modules(names + ["jax", "flax.linen"]) == [
        "flax", "jax"]
