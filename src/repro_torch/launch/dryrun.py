"""Dry-run of every (arch x shape x mesh) cell on a fake process group
(port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's program for 512 fake host
devices and reads XLA's cost and memory analyses and the collectives of
its HLO. Here the program is eager PyTorch, so the dry-run runs it: this
process is rank 0 of a fake process group (torch's ``fake`` backend,
whose collectives move nothing) of 256 ranks (512 with ``--multi-pod``),
the mesh is ``make_production_mesh(device_type="cpu")`` (it holds no
tensor of the step's), the cell's arguments are fake tensors of rank
0's block shapes under ``prog.in_specs`` on the card's path
(``card_device``: fake CUDA tensors where torch has a card, fake meta
ones elsewhere; either takes ``attention._mm``'s
``bmm(out_dtype=float32)``; ``device="cpu"`` traces the CPU's path,
which gloo ranks run), and ``prog.fn`` (its backward included, where
the step has one) runs under ``FakeTensorMode`` and
``analysis.op_trace.OpCounter``. Nothing is allocated: a 16 x 16 cell of
mixtral traces on a laptop's CPU.

A record keeps the reference's keys. ``hlo_flops`` and ``hlo_bytes``
keep their names so that readers of either package's JSON match, but
here they count eager aten ops on one rank: there is no fusion, so the
bytes are an upper bound against a fused program's. ``per_device_memory``
is the peak of the rank's live tensors (its arguments included). There
is no scan correction (the reference's probes of 1- and 2-layer
variants): every layer runs in Python, so the counts are whole
(``collectives["scan_corrected"]`` is False, ``layers_traced`` says how
many ran). The attention's tile loops run two tiles and count the
second for every later one (``op_trace.tiles``: every tile dispatches
the same ops); ``tiles_replayed`` counts the tiles counted but not run.
A host plan built from an index needs its values, which a fake tensor
has not: it is built from a stand-in index of the same shape and bound
(``core.formats.plan_index``), which gives the same shapes, FLOPs and
collectives; ``plan_stand_ins`` counts them, and the bytes of their
plans are the stand-in's. The compute peak is the one of the products'
dtype (``analysis.roofline.compute_peak``), named in ``peak``.

A process has one default process group, so the dry-run is a process of
its own, as the reference's is.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --cell train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]
      [--jobs N]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.op_trace import OpCounter, _tensors
from repro_torch.analysis.roofline import analyze_trace
from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.core.formats import STAND_IN
from repro_torch.distributed.sharding import _specs_like, local_slice
from repro_torch.launch.mesh import (PRODUCTION_SHAPES, make_production_mesh,
                                     mesh_shape)
from repro_torch.tree import tree_unflatten

MESH_NAMES = {False: "16x16", True: "2x16x16"}
# the fake backend for every device a trace's tensors may be on (the meta
# device included: the halo exchange's batched sends ask for its backend)
FAKE_BACKEND = "cpu:fake,cuda:fake,meta:fake"
# one fake mode for every trace of this process: constants the models
# cache on first use (``so3.cg_tensor``) are its fake tensors
_FAKE = []


def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    if not _FAKE:
        _FAKE.append(FakeTensorMode())
    return _FAKE[0]


def fake_world(world_size: int) -> None:
    """This process as rank 0 of a fake process group of ``world_size``
    ranks; a fake group of another size is replaced. Refuses where a real
    process group is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != FAKE_BACKEND:
            raise RuntimeError("the dry-run needs a process of its own: a "
                               f"{dist.get_backend()} group is up")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0,
                            world_size=world_size)


def place(prog, mesh, mode, device: str) -> tuple:
    """``prog.args`` as fake tensors on ``device`` (made under ``mode``)
    of rank 0's blocks under ``prog.in_specs``."""
    out = []
    for tree, specs in zip(prog.args, prog.in_specs):
        leaves, sp = _specs_like(tree, specs)
        shapes = [tuple(s.stop - s.start for s in
                        local_slice(spec, tuple(x.shape), mesh, 0))
                  for x, spec in zip(leaves, sp)]
        with mode:
            out.append(tree_unflatten(tree, [
                torch.empty(shape, dtype=x.dtype, device=device)
                for x, shape in zip(leaves, shapes)]))
    return tuple(out)


def _nbytes(tree) -> int:
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return int(sum(seen.values()))


def card_device() -> str:
    """The device whose fake tensors trace the card's path: "cuda" where
    torch has a card, else "meta". A CPU-only torch builds fake CUDA
    tensors but cannot record autograd on them (it has no CUDA device
    guard), and the port's only device-dependent branch,
    ``attention._mm``, takes the card's side on any device but the CPU,
    so the meta device traces the same ops."""
    return "cuda" if torch.cuda.is_available() else "meta"


def trace(prog, mesh, mesh_name: str, *, layers: int = 0,
          device: str | None = None) -> dict:
    """The dry-run record of one built cell: ``prog.fn`` on fake tensors
    of rank 0's blocks on ``device``, counted, on the fake process group
    that ``mesh`` spans (``layers``: the depth, for ``layers_traced``).
    ``device`` None: ``card_device()``, the card's path; "cpu" traces
    the path that gloo ranks run."""
    device = device or card_device()
    chips = int(np.prod(list(mesh_shape(mesh).values())))
    stand_ins = STAND_IN["plans"]
    t0 = time.perf_counter()
    mode = fake_mode()
    args = place(prog, mesh, mode, device)
    counter = OpCounter()
    counter.track(args)
    t1 = time.perf_counter()
    with mode, counter:
        out = prog.fn(*args)
    t2 = time.perf_counter()
    counts = counter.counts()
    roof = analyze_trace(prog.arch, prog.cell, mesh_name, chips, counts,
                         prog.model_flops)
    rec = roof.to_dict()
    rec["collectives"]["scan_corrected"] = False
    arg_bytes = _nbytes(args)
    rec.update({
        "step": prog.step_name, "lower_s": t1 - t0, "compile_s": t2 - t1,
        "status": "ok", "t_bound": roof.t_bound,
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": _nbytes(out),
            "temp_size_in_bytes": int(counts["peak_bytes"]) - arg_bytes},
        "peak": roof.peaks(), "flops_by_dtype": counts["flops_by_dtype"],
        "layers_traced": int(layers), "ops": counts["n_ops"],
        "tiles_replayed": counts["replayed"],
        "plan_stand_ins": STAND_IN["plans"] - stand_ins,
        "traced_on": f"fake {device} tensors, rank 0"})
    return rec


def run_cell(arch_name: str, cell_name: str, *, multi_pod: bool = False,
             verbose: bool = True) -> dict:
    from repro_torch.launch.specs import build_cell

    shape, _ = PRODUCTION_SHAPES[bool(multi_pod)]
    fake_world(int(np.prod(shape)))
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    mesh_name = MESH_NAMES[bool(multi_pod)]
    t0 = time.perf_counter()
    prog = build_cell(arch_name, cell_name, mesh)
    t_build = time.perf_counter() - t0
    rec = trace(prog, mesh, mesh_name,
                layers=getattr(get_arch(arch_name).config, "n_layers", 0))
    rec["lower_s"] += t_build
    if verbose:
        gb = rec["memory_analysis"]
        print(f"[{mesh_name}] {arch_name}/{cell_name} ({prog.step_name}) "
              f"OK  lower {rec['lower_s']:.1f}s trace {rec['compile_s']:.1f}s"
              f" | args {gb['argument_size_in_bytes'] / 2**30:.2f} GiB temp "
              f"{gb['temp_size_in_bytes'] / 2**30:.2f} GiB (per dev) | "
              f"bottleneck={rec['bottleneck']} "
              f"t=({rec['t_compute']:.2e},{rec['t_memory']:.2e},"
              f"{rec['t_collective']:.2e})s mfu_bound={rec['mfu_bound']:.3f}",
              flush=True)
    return rec


def run_target(arch: str, cell: str, multi_pod: bool) -> dict:
    """``run_cell``'s record, or a ``skip`` / ``error`` record."""
    from repro_torch.launch.specs import SkippedCell

    mesh_name = MESH_NAMES[bool(multi_pod)]
    try:
        return run_cell(arch, cell, multi_pod=multi_pod)
    except SkippedCell as e:
        print(f"[{mesh_name}] SKIP {e}", flush=True)
        return {"arch": arch, "cell": cell, "status": "skip",
                "mesh": mesh_name, "reason": str(e)}
    except Exception as e:                   # recorded, the run goes on
        traceback.print_exc()
        return {"arch": arch, "cell": cell, "status": "error",
                "mesh": mesh_name, "error": f"{type(e).__name__}: {e}"}


def _worker_init() -> None:
    torch.set_num_threads(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each worker a process of "
                         "its own (default 1: in this process)")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    targets = []
    if args.all:
        for a in ASSIGNED:
            for c in get_arch(a).shapes:
                targets.append((a, c.name))
    else:
        arch = args.arch
        cells = ([args.cell] if args.cell
                 else [c.name for c in get_arch(arch).shapes])
        targets = [(arch, c) for c in cells]
    jobs = [(a, c, mp_) for mp_ in meshes for a, c in targets]

    if args.jobs > 1:
        with ProcessPoolExecutor(args.jobs, mp_context=mp.get_context(
                "spawn"), initializer=_worker_init) as pool:
            records = list(pool.map(run_target, *zip(*jobs)))
    else:
        records = [run_target(*j) for j in jobs]

    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)

        def key(r):
            return (r["arch"], r["cell"], r.get("mesh"))
        merged = {key(r): r for r in existing}
        for r in records:
            merged[key(r)] = r
        with open(args.out, "w") as f:
            json.dump(list(merged.values()), f, indent=1)
        print(f"wrote {len(merged)} records -> {args.out}")
    n_err = sum(1 for r in records if r.get("status") == "error")
    print(f"done: {len(records)} cells, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
