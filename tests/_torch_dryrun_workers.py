"""Programs of ``tests/test_torch_dryrun.py``: the dry-run's trace on a
fake process group (``fake_main``, a process of its own) and the same
cell run on real tensors on gloo ranks (``real_lm``, through
``repro_torch.launch.local.run_ranks``). Both import the port only, so
that they start without JAX; results go back as JSON-able dicts.
"""
import dataclasses
import json
import sys

import torch

from repro_torch.analysis.op_trace import OpCounter
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamW

AXES = ("data", "model")
FULL_CELLS = (("smollm-360m", "train_4k"), ("fm", "serve_p99"),
              ("gatedgcn", "full_graph_sm"))
# qwen3-0.6b-smoke's train cell, cut to 4 x 96 tokens
SMOKE_ARCH = "qwen3-0.6b"
SMOKE_CELL = ShapeCell("train_smoke", "train", seq_len=96, global_batch=4)


def smoke_prog(mesh):
    from repro_torch.launch import specs

    arch = get_arch(SMOKE_ARCH)
    arch = dataclasses.replace(arch, config=arch.smoke)
    return specs.build_lm_cell(arch, SMOKE_CELL, mesh)


def _counts(c: OpCounter) -> dict:
    out = c.counts()
    out["collectives"] = [list(r) for r in out["collectives"]]
    return json.loads(json.dumps(out))


# one small cell of every assigned arch, at its smoke config
FAMILY_CELLS = {
    "train": SMOKE_CELL,
    "graph_full": ShapeCell("g", "graph_full", n_nodes=64, n_edges=256,
                            d_feat=8),
    "graph_batched": ShapeCell("m", "graph_batched", n_nodes=8, n_edges=16,
                               global_batch=8),
    "rec_train": ShapeCell("r", "rec_train", global_batch=8),
}


def family_progs(mesh) -> list:
    """[(arch, cell, program)]: each assigned arch at its smoke config on
    a small cell of its family's first kind (the geometric GNNs on their
    molecule cell)."""
    from repro_torch.configs import ASSIGNED
    from repro_torch.configs.base import GNNConfig, TransformerConfig
    from repro_torch.launch import specs

    out = []
    for name in ASSIGNED:
        arch = get_arch(name)
        arch = dataclasses.replace(arch, config=arch.smoke)
        cfg = arch.config
        if isinstance(cfg, TransformerConfig):
            cell, build = FAMILY_CELLS["train"], specs.build_lm_cell
        elif isinstance(cfg, GNNConfig):
            kind = ("graph_batched" if name in ("dimenet", "nequip")
                    else "graph_full")
            cell, build = FAMILY_CELLS[kind], specs.build_gnn_cell
        else:
            cell, build = FAMILY_CELLS["rec_train"], specs.build_fm_cell
        out.append((name, cell.name, build(arch, cell, mesh)))
    return out


class _Counted:
    """``torch.bmm`` counting its calls with an ``out_dtype``."""

    def __init__(self):
        self.bmm, self.with_out_dtype = torch.bmm, 0

    def __call__(self, *args, **kwargs):
        if kwargs.get("out_dtype") is not None:
            self.with_out_dtype += 1
        return self.bmm(*args, **kwargs)


def _no_kernel(*args, **kwargs):
    raise RuntimeError("the dry-run reached a hand kernel's loader")


def fake_main() -> None:
    """Prints one JSON line: the three full-config cells' records on 4x2
    (a fake group of 8); on (2, 2) (a fake group of 4) the smoke cell's
    record on fake CPU tensors (the path gloo ranks run) and on the
    card's path (``dryrun.card_device``), each with the ``bmm`` calls
    given an ``out_dtype``; and one cell of every assigned arch traced
    with the kernels' loader made to raise, with the kernel wrappers'
    calls."""
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.specs import build_cell

    out = {"full": []}
    dryrun.fake_world(8)
    mesh = make_mesh((4, 2), AXES, "cpu")
    for arch, cell in FULL_CELLS:
        out["full"].append(dryrun.trace(build_cell(arch, cell, mesh), mesh,
                                        "4x2"))
    dryrun.fake_world(4)
    mesh = make_mesh((2, 2), AXES, "cpu")
    bmm = torch.bmm = _Counted()
    try:
        for key, dev in (("smoke", "cpu"), ("smoke_card", None)):
            before = bmm.with_out_dtype
            out[key] = dryrun.trace(smoke_prog(mesh), mesh, "2x2",
                                    device=dev)
            out[key]["bmm_out_dtype"] = bmm.with_out_dtype - before
    finally:
        torch.bmm = bmm.bmm
    _build.library = _build.build_all = _build._nvcc = _no_kernel
    calls = ops.entry_counts()
    out["families"] = [
        dict(arch=arch, cell=cell, status=dryrun.trace(
            prog, mesh, "2x2")["status"])
        for arch, cell, prog in family_progs(mesh)]
    out["kernel_calls"] = [calls, ops.entry_counts()]
    print("RESULT " + json.dumps(out, default=str))
    sys.stdout.flush()


def real_lm(rank, world, seed: int) -> dict:
    """The smoke cell's ``fn`` on this rank's blocks of real tensors
    (seeded parameters, AdamW state, tokens), under ``OpCounter``."""
    from repro_torch.core.formats import STAND_IN

    mesh = make_mesh((2, 2), AXES, "cpu")
    prog = smoke_prog(mesh)
    cfg = get_arch(SMOKE_ARCH).smoke
    params = T.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (SMOKE_CELL.global_batch,
                                          SMOKE_CELL.seq_len), generator=gen,
                           dtype=torch.int32)
    full = (params, AdamW(lr=1e-4, weight_decay=0.01).init(params),
            {"tokens": tokens, "labels": tokens})
    args = tuple(shd.shard_tree(a, s, mesh)
                 for a, s in zip(full, prog.in_specs))
    counter = OpCounter()
    counter.track(args)
    with counter:
        prog.fn(*args)
    return {"counts": _counts(counter), "stand_ins": STAND_IN["plans"]}


if __name__ == "__main__":
    fake_main()
