"""Run one cell of the benchmark once.

    python -m hgcn_bench.run --workload reddit.batch --seed 7 \
        --seconds 20 --trace 0

Looks up the cell in ``BENCHMARK.json``, drives ``repro_torch`` on the
card with the cell's traffic for ``--seconds``, checks the served
logits against the plain reference, and prints the result as the last
line of standard output: one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, optionally
``breakdown``, and ``checks`` last (each compared number with its
limit, also the last lines of standard error).

Exits non-zero and prints no result for a workload, configuration or
model module (``models/<model.kind>.py``) it cannot find, without a card
(or with fewer cards than the cell asks for), without the program beside
the benchmark, or when JAX or the JAX package has been loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from hgcn_bench.spec import ROOT, model_of, resolve  # noqa: E402

# top-level module names that must never be loaded by a run: JAX and the
# JAX package the program was ported from (``repro_torch`` is not
# ``repro``: names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the
    modules loaded in this process)."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = resolve(args.workload)
        model_of(cell.config)
    except (OSError, KeyError, ValueError) as err:
        print(f"hgcn_bench: {err}", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"hgcn_bench: the program is not beside the benchmark "
              f"({src / 'repro_torch'} missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hgcn_bench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from hgcn_bench.cell import run_cell

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"hgcn_bench: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
