"""The dry-run (``repro_torch.launch.dryrun``) against real runs.

The reference's dry-run cannot be the oracle here: on the installed jax
it fails to compile (ROADMAP, facts about the reference). So the port's
counts are held against runs of the same programs on real tensors:

- the reference test's three cells at full config (smollm-360m
  ``train_4k``, fm ``serve_p99``, gatedgcn ``full_graph_sm``) trace on
  a fake process group of 8 ranks on 4 x 2: each ``ok``, with FLOPs and
  a bound;
- qwen3-0.6b-smoke's train cell (``build_lm_cell``, 4 x 96 tokens)
  traced on fake tensors on (2, 2) equals the reading of the same
  counter around the same cell on real tensors on 4 gloo ranks: FLOPs
  (by dtype) and the collectives (count and bytes by kind) exactly
  (both runs take the CPU's path through the same ops; the trace builds
  its one host plan, the embedding gradient's, from a stand-in index,
  whose plan has the real one's shapes). The peak of live bytes is at
  most 1 % above the real run's and never below: the trace also holds
  the host constants it makes tensors (``lift_fresh``: its plans,
  which the card's run copies to the device), which a real CPU run
  makes without an op (176 bytes here). The bytes of the real run
  are at most 5 % above the trace's and never below: gloo copies the
  buffers of its collectives with aten ``copy_`` ops that the counter
  sees on the calling thread (1.6 % of this cell's bytes), where the
  fake backend, like NCCL on the card, dispatches none;
- the attention's tile loops, counted once per tile on fake tensors,
  equal a real run of every tile exactly;
- the stand-in plan (``core.formats.plan_index``) is built for fake
  tensors only: real steps through every host plan (the FM lookup and
  its row-sharded gradient, the GNN's segment sums and halo plans, the
  MoE combine) build none;
- by default the trace takes the card's path (``dryrun.card_device``:
  fake CUDA tensors where torch has a card, else fake meta ones): the
  smoke cell's attention products are ``bmm(out_dtype=float32)`` on
  bf16 tiles, with the CPU trace's FLOPs and collectives and fewer
  bytes (no f32 copies of the tiles);
- with the kernels' loader made to raise, a cell of every assigned arch
  still traces, and no kernel wrapper is entered: the dry-run's path
  holds no hand kernel.
"""
import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis.op_trace import OpCounter
from repro_torch.core import formats
from repro_torch.launch.local import run_ranks
from repro_torch.models.attention import chunked_attention

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_dryrun_workers as W  # noqa: E402

TIMEOUT_S = 300.0


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the fake traces' JSON, the real 4-rank run's per-rank results):
    the trace in a process of its own, the gloo ranks meanwhile."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(HERE), "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src, HERE] + [p for p in [env.get("PYTHONPATH")] if p])
    pool = concurrent.futures.ThreadPoolExecutor(1)
    real = pool.submit(run_ranks, W.real_lm, 4, 7, backend="gloo",
                       store_dir=str(tmp_path_factory.mktemp("dry4")),
                       timeout_s=TIMEOUT_S)
    proc = subprocess.run([sys.executable, os.path.join(
        HERE, "_torch_dryrun_workers.py")], env=env, capture_output=True,
        text=True, timeout=TIMEOUT_S)
    pool.shutdown(wait=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), real.result()


REF_KEYS = ("arch", "cell", "mesh", "chips", "hlo_flops", "hlo_bytes",
            "collective_bytes", "model_flops", "per_device_memory",
            "t_compute", "t_memory", "t_collective", "bottleneck",
            "useful_flops_ratio", "mfu_bound", "collectives", "step",
            "lower_s", "compile_s", "status", "memory_analysis")


@pytest.mark.parametrize("i", range(len(W.FULL_CELLS)),
                         ids=[f"{a}/{c}" for a, c in W.FULL_CELLS])
def test_full_config_cells_trace_on_4x2(i, results):
    rec = results[0]["full"][i]
    assert (rec["arch"], rec["cell"]) == W.FULL_CELLS[i]
    assert set(REF_KEYS) <= set(rec)
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["hlo_flops"] > 0 and rec["t_bound"] > 0
    assert rec["collectives"]["scan_corrected"] is False
    assert rec["peak"]["flops_per_s"] in (989e12, 67e12)


def _by_kind(records):
    from repro_torch.analysis.op_trace import Recorded, collective_summary
    return collective_summary([Recorded(r[0], r[1], tuple(map(tuple, r[2])),
                                        tuple(r[3])) for r in records])


def test_fake_trace_equals_the_real_run(results):
    fake, real = results
    rec, got = fake["smoke"], real[0]["counts"]
    assert rec["hlo_flops"] == got["flops"] > 0
    assert rec["flops_by_dtype"] == got["flops_by_dtype"]
    assert rec["collectives"]["by_kind"] == _by_kind(got["collectives"])[
        "by_kind"]
    assert rec["collectives"]["n_ops"] == len(got["collectives"]) > 0
    assert rec["hlo_bytes"] <= got["bytes"] <= 1.05 * rec["hlo_bytes"]
    assert got["peak_bytes"] <= rec["per_device_memory"] <= \
        1.01 * got["peak_bytes"]
    assert rec["plan_stand_ins"] == 1


def test_trace_takes_the_cards_branch_by_default(results):
    cpu, card = results[0]["smoke"], results[0]["smoke_card"]
    assert cpu["traced_on"] == "fake cpu tensors, rank 0"
    assert card["traced_on"] in ("fake cuda tensors, rank 0",
                                 "fake meta tensors, rank 0")
    assert cpu["bmm_out_dtype"] == 0 and card["bmm_out_dtype"] > 0
    assert card["hlo_flops"] == cpu["hlo_flops"] > 0
    assert card["collectives"] == cpu["collectives"]
    assert card["hlo_bytes"] < cpu["hlo_bytes"]
    # the products count in their operands' dtype: bf16 tiles, not copies
    assert card["flops_by_dtype"]["bfloat16"] > \
        cpu["flops_by_dtype"]["bfloat16"]


def test_every_arch_traces_without_a_kernel(results):
    from repro_torch.configs import ASSIGNED

    fams = results[0]["families"]
    assert [f["arch"] for f in fams] == list(ASSIGNED)
    assert all(f["status"] == "ok" for f in fams), fams
    before, after = results[0]["kernel_calls"]
    assert before == after


def test_real_ranks_build_no_stand_in(results):
    assert [r["stand_ins"] for r in results[1]] == [0, 0, 0, 0]


def _attention_counts(fake: bool, causal: bool) -> dict:
    """The counter's reading of one chunked attention (4 x 4 tiles) and
    its backward, on fake tensors (tiles replayed) or on real ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shapes = ((2, 32, 4, 8), (2, 32, 2, 8), (2, 32, 2, 8))
    if fake:
        mode = FakeTensorMode()
        with mode:
            leaves = [torch.empty(s, requires_grad=True) for s in shapes]
    else:
        mode = contextlib.nullcontext()
        gen = torch.Generator().manual_seed(0)
        leaves = [torch.randn(s, generator=gen).requires_grad_()
                  for s in shapes]
    counter = OpCounter()
    counter.track(leaves)
    with mode, counter:
        pos = torch.arange(32)
        out = chunked_attention(*leaves, q_pos=pos, kv_pos=pos,
                                causal=causal, q_chunk=8, k_chunk=8)
        torch.autograd.grad(out.sum(), leaves)
    return counter.counts()


@pytest.mark.parametrize("causal", [True, False])
def test_replayed_tiles_count_as_every_tile(causal):
    fake, real = (_attention_counts(f, causal) for f in (True, False))
    assert fake["replayed"] > 0 and real["replayed"] == 0
    for key in ("flops", "flops_by_dtype", "pointwise_flops", "bytes",
                "n_ops", "peak_bytes"):
        assert fake[key] == real[key], key


def test_plan_index_stand_in_only_for_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode

    idx = torch.tensor([[3, 1], [4, 1]])
    before = formats.STAND_IN["plans"]
    np.testing.assert_array_equal(formats.plan_index(idx, 5), idx.numpy())
    assert formats.STAND_IN["plans"] == before
    with FakeTensorMode():
        fake = torch.empty((2, 2), dtype=torch.int64)
    np.testing.assert_array_equal(formats.plan_index(fake, 3),
                                  [[0, 1], [2, 0]])
    assert formats.STAND_IN["plans"] == before + 1


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    store = tmp_path_factory.mktemp("dry1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_real_steps_build_no_stand_in(one_rank):
    """Steps on real tensors through every host plan: the FM train cell
    (row-sharded lookup and gradient, on (1, 1)), a halo-sharded
    gatedgcn step and a sampled-subgraph one (segment sums, halo plans),
    and an MoE forward (the combine's segment sum)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    before = formats.STAND_IN["plans"]
    gen = torch.Generator().manual_seed(0)

    def real(prog):
        def fill(x):
            if x.dtype.is_floating_point:
                return torch.randn(tuple(x.shape), generator=gen) * 0.1
            if x.dtype == torch.bool:
                return torch.ones(tuple(x.shape), dtype=torch.bool)
            return torch.randint(0, 2, tuple(x.shape), generator=gen,
                                 dtype=x.dtype)   # ids and labels: 0 or 1
        return tuple(tree_map(fill, a) for a in prog.args)

    fm = get_arch("fm")
    fm = dataclasses.replace(fm, config=fm.smoke)
    prog = specs.build_fm_cell(fm, ShapeCell("t", "rec_train",
                                             global_batch=8), one_rank)
    prog.fn(*real(prog))
    for arch, kind in (("gatedgcn", "graph_full"),
                       ("gatedgcn", "graph_minibatch")):
        a = get_arch(arch)
        a = dataclasses.replace(a, config=a.smoke)
        cell = ShapeCell("g", kind, n_nodes=64, n_edges=256, d_feat=8,
                         batch_nodes=4, fanout=(2, 2))
        prog = specs.build_gnn_cell(a, cell, one_rank)
        prog.fn(*real(prog))
    cfg = get_arch("mixtral-8x7b").smoke
    params = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    T.forward(params, tokens, cfg, q_chunk=8, k_chunk=8)
    assert formats.STAND_IN["plans"] == before
