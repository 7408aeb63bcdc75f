"""repro_torch-lint: ahead-of-time invariant checkers for the port.

Port of ``repro.analysis.static``. Three passes, each importable on its
own and all driven by ``python -m repro_torch.analysis.static``:

- ``launch_pass``      — runs the fixture engine's dispatch path and
                         proves its structural invariants (one ragged
                         and one dense launch per layer, no host syncs,
                         float32 shape flow, sentinel and dead-lane
                         safety); the port's counterpart of the
                         reference's ``jaxpr_pass``.
- ``kernel_pass``      — audits the CUDA launch contracts exported by
                         ``repro_torch.kernels`` (grid, threads, shared
                         memory, 32-bit extents, alignment, index
                         bounds, ptxas registers and spills) and acts as
                         the shape-class legality oracle and the
                         autotuner's.
- ``concurrency_pass`` — AST lock-discipline lint over the port's
                         serving, engine and obs packages (field races,
                         lock order).
"""
from repro_torch.analysis.static.report import Finding, Report  # noqa: F401
