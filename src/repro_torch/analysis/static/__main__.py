"""repro_torch-lint: the port's static invariant checker.

    python -m repro_torch.analysis.static [--passes launch,kernel,concurrency]
                                          [--device cuda|cpu] [-v]
                                          [--bench-check [ROOT]]

Port of ``scripts/lint_repro.py``. Three passes:

  launch       runs the fixture GCN executor on the "ragged" dispatch and
               checks launch discipline (one ragged ELL and one dense
               call per layer, no fixed-K call; on a card also the
               profiled kernels), no host sync inside the forward,
               float32 shape flow from ``prepare_x`` to the logits, the
               sentinel layout, and that NaN in every masked ELL lane
               leaves the logits bitwise-equal.
  kernel       audits the launch contracts of ``kernels/ell_spmm.py`` and
               ``kernels/tile_matmul.py`` against sm_90's limits and the
               build's ptxas log, and re-derives the shape-class fit
               oracle against the runtime's ``class_fits``.
  concurrency  AST lock-discipline audit over ``src/repro_torch/
               {serving,engine,obs}``: worker-thread writes reachable
               from the public API without the owning lock, plus
               lock-order inversions against the declared hierarchy.

``--device`` is where the launch and kernel passes run: the card by
default (the kernels are built, and their ptxas logs audited); without
one those passes raise unless ``--device cpu`` is given, where the
kernels' plain versions run and the registers rule reports "not
checked". The concurrency pass and ``--bench-check`` need no device.
Benign races carry inline waivers, ``# lint: racy-ok(<reason>)``, listed
under ``-v``.

``--bench-check [ROOT]`` validates the ``BENCH_*.json`` trajectory files
at ROOT (default: the repository's root) against their schema
(``bench_check``); given without ``--passes`` it runs no other pass.

Exit status is 1 iff any unwaived error finding survives.
"""
from __future__ import annotations

import argparse
import sys

ALL_PASSES = ("launch", "kernel", "concurrency")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.static",
        description="static invariant checker (launch / kernel / "
                    "concurrency passes)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of "
                         f"{{{','.join(ALL_PASSES)}}} (default: all, or "
                         "none with --bench-check)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the launch and kernel passes run (default: "
                         "the card; without one, pass --device cpu)")
    ap.add_argument("--bench-check", nargs="?", const="", default=None,
                    metavar="ROOT",
                    help="validate the BENCH_*.json trajectory files at "
                         "ROOT (default: the repository's root)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print waived findings and warnings")
    args = ap.parse_args(argv)

    bench = args.bench_check is not None
    passes = args.passes if args.passes is not None else (
        "" if bench else ",".join(ALL_PASSES))
    requested = [p.strip() for p in passes.split(",") if p.strip()]
    unknown = [p for p in requested if p not in ALL_PASSES]
    if unknown:
        ap.error(f"unknown pass(es): {', '.join(unknown)}")

    from repro_torch.analysis.static.report import Report
    from repro_torch.device import resolve_device
    on_device = bool({"launch", "kernel"} & set(requested))
    device = args.device
    if on_device:
        resolve_device(device)     # no card: raises, naming device='cpu'
    report = Report()
    engine = None
    for pass_name in requested:
        if pass_name == "concurrency":
            from repro_torch.analysis.static.concurrency_pass import (
                run_concurrency_pass)
            report.extend(run_concurrency_pass())
            continue
        if engine is None:
            from repro_torch.analysis.static.fixtures import fixture_engine
            engine = fixture_engine(device=device)
        if pass_name == "launch":
            from repro_torch.analysis.static.launch_pass import (
                run_gat_launch_pass, run_launch_pass)
            report.extend(run_launch_pass(engine))
            report.extend(run_gat_launch_pass(device=device))
        else:
            from repro_torch.analysis.static.kernel_pass import (
                run_kernel_pass)
            report.extend(run_kernel_pass(engine))
    if bench:
        from repro_torch.analysis.static.bench_check import check_bench_files
        from repro_torch.analysis.static.concurrency_pass import _repo_root
        report.extend(check_bench_files(args.bench_check or _repo_root()))
    print(f"repro_torch-lint: passes {','.join(requested + ['bench'] * bench)}"
          f" on {device if on_device else 'the host'}")
    print(report.render(verbose=args.verbose))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
