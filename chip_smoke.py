"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository's ``src/`` next to this file. It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. drives the main path: registers cora, citeseer and pubmed at full
     size with the paper's 2-layer GCN (hidden 128, seeded Glorot
     weights), then serves each graph one ``infer`` and one 4-request
     ``serve_group``, with the kernels' launch counters set to 0 just
     before and read just after;
  4. checks the main path: logits finite and of the right shape, within
     tolerance of the port's plain "torch" backend on the same card,
     ``serve_group`` outputs bitwise-equal to per-request ``infer`` (X·W
     is one 2-D product per group member, so no bit depends on the group
     size), repeat runs bitwise-equal, and exactly one launch of each
     kernel per layer;
     profiles one ``infer`` per graph (``torch.profiler``): kernels and
     device ms per infer, the card's busy share, and the launches of the
     kernels named in ``PROFILE_NAMES`` (the ELL, BSR and COO row kernels,
     gathers, ``segment_reduce`` and its scans, elementwise kernels);
  5. the serving front end over the main path's engine
     (``repro_torch.serving.RequestQueue``, host features as a user
     submits them, 4 requests per graph): serial on a worker thread,
     pipelined, two replica lanes on the one card, and under chaos (one
     poisoned request name quarantined by bisection; a hung dispatch
     reclaimed by the dispatch watchdog); results bitwise-equal to
     ``serve_group`` and to ``infer`` (the chaos batch-mates too), two
     launches of each kernel per batch, and each
     warm latency sample at least its dispatch's device time; prints
     one ``{"serving": ...}`` line;
  6. reordered graphs on the main path: cora and pubmed at full size,
     reordered by their planted communities (``reorder(csr, "labels",
     ...)``), each served one ``infer`` with the launches of the main
     path and logits within tolerance of the plain backend (cora's also
     of the unreordered graph); cora's class has no dense tile, and
     ``bsr_spmm_rows`` on that empty dense part must give zeros without a
     launch;
  7. dispatch A/B: the same requests through ``Engine(ell_dispatch=d)``
     for the per-K dispatches "fused" and "loop" (one ``ell_spmm`` launch
     per layer for every class band, which also sums the unit rows onto
     rows and adds them onto the dense rows; no ``ragged_ell_spmm``);
     logits must equal the ragged dispatch's bit for bit, repeats
     bitwise; one ``infer`` of each is profiled beside the ragged
     dispatch's, and its ELL part must be the band kernel alone;
  8. lifecycle, on the "ragged" and the "fused" dispatch: three
     pubmed-shaped graphs of one shape class, served, then their class
     retired by a ``LifecycleManager`` window; the successors are
     tighter and at least one has fewer padded rows (so X·W and the
     dense-tile grid run at a new M), ``spmm`` is bitwise-equal across
     the retirement, ``infer`` within tolerance (bitwise equality
     printed), and a replica view serves a successor class as the
     engine does;
  9. the matmul path: the GCN's X·W products of the main path through
     ``kernels.ops.matmul`` (the ``tile_matmul`` kernel);
 10. X·W: one 2-D product per group member against one batched
     product at each graph's group of 4, device ms of both and whether
     the batched members equal the 2-D products bit for bit;
 11. autotune: ``Engine.autotune`` on the classes of cora (citeseer's
     too), pubmed and cora@labels, each at the hidden width and at its
     output width, with the device timer (CUDA graphs of the tuned launch
     on the graph's own class-padded rows), sweeping the launch shape and
     ``max_bands`` 4 and 1; prints each sweep's time and per-candidate
     device ms and the rejected candidates with their audit findings,
     and the device ms of the GCN forward with each graph's applied
     tuning (a config per width) against the defaults. Gates: only
     candidates without an audit error are timed; each timed
     candidate's ``ragged_ell_rows`` bitwise-equal to the default's on
     the class's real inputs and bands; each width's winner applied
     at that width; tuned ``infer`` bitwise-equal to untuned; a second
     ``autotune`` a cache hit that times nothing;
 12. lint: the three passes of ``python -m repro_torch.analysis.static``
     on the card (kernel contracts against the build's ptxas logs; the
     launch pass's profile: one ragged and one dense launch per layer,
     no host sync in the forward), then the launch and kernel passes over
     the main path's engine and its tuned classes; no unwaived error;
 13. training (``repro_torch.examples.quickstart``'s run, the launch
     counters set to 0 just before and read just after): cora reordered
     by its planted labels (hidden 128, AdamW 5e-3, 60 steps, "ragged")
     and pubmed in its natural order (20 steps), each differentiated
     through ``HybridSpmmFn`` (the backward runs the same kernels over
     Aᵀ's partition); pubmed with random edge values (not symmetric) for
     the first step's gradients only. Gates: cora learns (loss below
     0.7x its first value, test accuracy > 0.5); the first step's weight
     gradients on "cuda" within ``GRAD_TOL`` of the "torch" backend's,
     and "fused" bitwise-equal to "ragged"; one launch of each path
     kernel per layer forward and backward in every step; Aᵀ built at
     most once per graph (only for the asymmetric one); 5-step reruns
     bitwise; the trained weights served through ``Engine`` within
     ``LOGIT_TOL`` of the training forward; a checkpoint round trip
     bitwise; each path kernel at its backward shape agrees with the
     plain engines. Reports step wall ms, device ms per step split into
     forward, backward and optimizer (profiler), the Aᵀ seconds, the
     step's largest device items and where its device-to-device copies
     come from; prints one ``{"train": ...}`` line;
 14. language models and FM (``repro_torch.models.{transformer,
     attention,fm}``, ``repro_torch.train.steps``; no hand kernel on this
     path): qwen3-0.6b at its full config (seeded weights on the card,
     ``TokenStream(seed=0)`` tokens) trains 8 AdamW steps at 2 x 4096
     tokens (bf16 compute, remat; the last three under the profiler);
     gates: losses finite and falling, no all-zero gradient, a 3-step
     rerun from the same state bitwise. At f32: decode after an
     (S-1)-token prefill equals the forward's last position within the
     reference's 5e-5 scaled by max(1, max |logits|), and the card's
     forward equals the port's plain CPU forward of the same weights.
     bf16 prefill of 8192 tokens at batch 1, 32 decode steps, then
     decode at batch 8 against a 32768-slot cache. mixtral-8x7b at full
     width with 2 layers: at f32 (no drops) a 4159-token prefill past
     the 4096 window (ring roll) and 4 decodes, each within 1e-4 of the
     windowed forward; bf16 prefill and decode timed. fm at its full
     config: 3 AdamW steps at batch 65536 (losses finite), serve at 512
     against the pairwise oracle, retrieval of one user's 20 fields
     over 1,000,000 candidates against direct scores. Reports wall and
     device ms, tokens (or rows) per second, model FLOPs as a share of
     the H100 SXM's 989 TFLOP/s BF16 peak, peak memory and the five
     largest device items; prints one ``{"lm": ...}`` and one
     ``{"fm": ...}`` line;
 15. geometric GNNs (``repro_torch.models.{dimenet,nequip,so3}``,
     ``distributed.collectives``; no hand kernel on this path): DimeNet
     (6 blocks, d 128) and NequIP (5 layers, 32 channels, l_max 2) at
     their full configs on the ``molecule`` cell (``random_molecules(128,
     30, cutoff=1.55)``, placed on the card once; seeded weights and
     target energies). Gates: f32 energies within 1e-4 · (max|cpu| +
     |cpu|) of the port's CPU forward; energies invariant under a
     seeded rotation and shift (the reference's tolerances); the
     all-zero gradient leaves those of the CPU; ``remat=True`` bitwise;
     20 AdamW steps finite and falling, a 3-step rerun bitwise; one
     step through the EF-compression hook with a non-zero residual.
     Then a G = 2 stacked cora ``gcn_forward`` (the normalized adjacency
     and an asymmetric copy) differentiated on the "cuda" backend:
     forward and each member's gradients bitwise-equal to the member
     alone. Reports serve and train step wall and device ms, busy share,
     molecules/s and peak memory; prints one ``{"geometric": ...}``
     line;
 16. the sharded layer (``repro_torch.{launch.mesh, distributed.{halo,
     sharding}, models.moe_ep}``; no hand kernel on this path) over an
     NCCL process group of one rank (a file store in a temporary
     directory) and its (1, 1) (data, model) mesh: gatedgcn at its full
     config (16 layers, d 70, 40 classes) on the full_graph_sm cell
     (cora's 2708 nodes and 12760 CSR entries as edges, seeded edge
     features of width 4) trains 20 AdamW steps through the halo ops
     with remat; gates: loss and parameters ``torch.equal`` to the
     unsharded step after every step, a 3-step rerun bitwise, losses
     falling; a profile of one step (launches, NCCL kernels, the
     exchange's share of device time). qwen3-moe-235b-a22b's
     expert-parallel layer at full width (128 experts on the one rank)
     on 4096 tokens: at f32 with capacity factor 16 (no drop)
     ``moe_ffn_ep`` equals ``moe_ffn``; at bf16 and the config's 1.25
     its values and gradients equal ``moe_ffn``'s and both are timed; a
     2-layer forward, prefill and decode step with
     ``moe_shardings={"ep_mesh": ...}`` equal the calls without it.
     Tensor-parallel, sequence-parallel and FSDP execution of the LM
     (``distributed.tp``; parameters placed by ``shard_tree``, the step
     given the reference's ``act_constraint`` for its config's
     ``parallelism``, 1 x 4096 tokens, remat, bf16; each step from the
     unsharded step's state):
     path C, qwen3-0.6b at its full config under "tp_fsdp" (3 AdamW
     steps); path D, granite-8b at full width under "fsdp" (depth cut
     36 -> 4, 3 steps); path E, mixtral-8x7b at full width, 1 layer,
     with the tensor-parallel MoE dict passed (1 step). Gates: loss and
     every parameter leaf ``torch.equal`` to ``make_lm_train_step``
     unsharded at each step, the collectives of each step (``tp.COUNTS``)
     equal to ``LMPlan.predicted_counts``. Path F: DimeNet and NequIP at
     full config on the molecule cell through the halo ops (3 AdamW
     steps each): loss and parameters ``torch.equal`` to the unsharded
     step at each step, two all-reduces a step (the energies' sum and its
     transpose). Each reports wall and device ms of both steps, the NCCL
     kernels' share, the collectives and peak memory. Then, on the CPU
     and labelled so, 4 gloo ranks on a (2, 2) mesh train gatedgcn's
     SMOKE config on an RCM-reordered SBM graph that keeps the halo
     contract, within 1e-5 of the single-rank step after 3 steps; and
     gloo ranks run qwen3-0.6b-smoke under "tp_fsdp" and granite-smoke
     under "fsdp" on (2, 2), mixtral-smoke (d_ff 96) with TP inside its
     experts on (1, 3) (loss and gathered gradients), DimeNet and NequIP
     SMOKE energy steps on 4 ranks (3 steps), each within ``rtol=1e-5,
     atol=1e-6`` of one process's unsharded step; cora's out-of-halo
     fractions at 4 and 8 shards are printed. One ``{"sharded": ...}``
     line;
 17. sharded serving (``repro_torch.launch.specs``, ``transformer.prefill``
     / ``decode_step`` with ``plan=``; no hand kernel on this path) over
     an NCCL group of one rank on its (1, 1) mesh: the prefill_32k and
     decode_32k cells of ``build_lm_cell`` (bf16 parameter structs, the
     serving plan under "tp_fsdp", the cell's MoE dict), parameters
     placed by ``shard_tree`` with the cell's ``in_specs``; path G,
     qwen3-0.6b at its full config; H, mixtral-8x7b at full width with 2
     layers, once with the cell's expert-parallel dict and once with the
     tensor-parallel one forced; I, granite-8b at full width with 4
     layers (its "fsdp" config served under "tp_fsdp"). The prefill cell
     at 1 x 32768 tokens (batch cut from 32), the decode cell at batch 8
     (cut from 128) with its cache from the prefill cell's step over a
     4159-token prompt (past mixtral's window: the ring rolls), then 4
     decodes. Path J: the long_500k decode cell of qwen3-0.6b (2 layers,
     batch 1, 524288 slots), one token into the empty cache. Gates: each
     cell's logits and caches ``torch.equal`` to the unsharded prefill /
     decode steps on the same bf16 parameters. Path K: ``build_cell`` of
     every cell of every arch in ``ASSIGNED`` on the (1, 1) mesh and on
     a duck-typed 16 x 16 one, on meta tensors: none may error. Then, on
     the CPU and labelled so, 4 gloo ranks prefill and decode 2 tokens
     at f32 for qwen3-0.6b-, granite-, mixtral- (3 experts, TP inside
     them) and qwen3-moe-smoke (EP) on (2, 2), (1, 4) and (4, 1), each
     within ``rtol=1e-5, atol=1e-6`` of one process's unsharded passes.
     Reports wall ms, device span (prefill) or profiled device ms
     (decode), tokens/s, collectives by kind and peak GiB, with the
     card's name and power limit; one ``{"serving_tp": ...}`` line;
 18. the dry-run (``repro_torch.launch.dryrun``, ``analysis.{op_trace,
     roofline}``; no hand kernel on this path): (a) ``python -m
     repro_torch.launch.dryrun --all`` on 16 x 16 in a process of its
     own (rank 0 of a fake process group of 256 ranks, every cell's
     step on fake tensors of its blocks, ``--jobs`` up to 8 processes,
     host only): 36 cells ok, 4 skipped, 0 errors; each cell's
     bottleneck, t_bound and mfu_bound (H100 SXM data-sheet peaks) is
     printed. (b) qwen3-0.6b ``train_4k`` (batch cut to 1, as path C),
     gatedgcn ``full_graph_sm``, fm ``train_batch`` at full config and
     mixtral-8x7b ``prefill_32k`` (2 layers, batch 1, as path H), traced
     on a (1, 1) mesh in a process of its own and run on the card over
     one NCCL rank (a warm-up call, one timed by CUDA events, one under
     ``OpCounter``): FLOPs and collectives by kind equal to the trace's,
     the traced peak of live bytes within 15 % of
     ``torch.cuda.max_memory_allocated()``, and t_bound at most 1.05 x
     the measured time. (c) the FM train, serve and retrieval cells'
     ``fn`` (tables' rows split over the one rank) ``torch.equal`` to
     the unsharded steps at full config. One ``{"dryrun": ...}`` line;
 19. bfloat16 (the reference's kernels' other type): the paper's GCN
     with bfloat16 features and weights on cora, citeseer and pubmed
     through ``gcn_forward(backend="cuda")`` on the "ragged", "fused" and
     "loop" dispatches over the engine's class-padded partitions, the
     launch counters set to 0 just before each dispatch's run over the
     three graphs and read just after (the kernels it runs must launch
     their bfloat16 instances, and no float32 one), and layer 1's X·W
     through ``ops.matmul`` (``tile_matmul``; ``gcn_forward``'s X·W is
     ``torch.matmul``) in a window of its own. Gates: logits bfloat16,
     finite, bitwise across the dispatches and a repeat, and bitwise the
     composition of the layers;
     each layer within ``bf16_close`` of the "torch" backend on the same
     input (``|got - ref| <= ulp_bf16(|ref|) + 2e-6 |A| @ |B|``, plus
     ``ulp_bf16`` of the dense rows, which the reference rounds on the
     way); X·W within ``bf16_close`` of its plain version. One
     ``{"bf16_gcn": ...}`` line;
 20. holds each of the four kernels against its plain PyTorch version at
     the shapes its path gave it, and times kernel, plain version and one
     library call with CUDA events: for the ELL row kernels
     (``ragged_ell_rows``, each unit to its band's K, and
     ``ell_spmm_rows``, every bucket in one launch, each unit to its
     bucket's K; also at the classes of cora and pubmed reordered by
     labels; the K trips at Kmax and at the bound printed)
     ``torch.sparse.mm`` over a CSR of the rows with an entry, then
     ``index_add_`` onto them; ``torch.matmul`` for ``tile_matmul``
     (every block configuration timed, all bitwise-equal); for the dense
     engine (``bsr_spmm_rows``: the BSR products summed per row tile in
     the kernel) ``torch.bmm`` on gathered B tiles followed by
     ``segment_sum``, with ``torch.bmm`` alone beside it. Each folded
     kernel must equal its per-tile / per-unit kernel followed by
     ``segment_sum`` (for the ELL rows also the add onto the dense rows;
     for the fixed-K rows also the "loop" chain of per-bucket sums and
     the ragged kernel; for the ragged rows also the Kmax pass) bit for
     bit;
     and, at bfloat16 (the cora class, F = 128 and 7; ``tile_matmul`` at
     every graph's layer 1 and layer 2, each time's share of its bound
     printed, and a spill of any of its wgmma instances failing the
     smoke): each ELL row kernel bitwise its float32 instance on
     ``b.float()`` in every launch shape the autotuner may pick, and
     bitwise its plain version; ``bsr_spmm_rows`` (tensor cores) and
     ``tile_matmul`` within ``bf16_close`` of their plain versions,
     bitwise across repeats, configurations and a G = 4 group; library
     calls ``torch.sparse.mm`` on B upcast to float32 (ELL),
     ``torch.bmm(out_dtype=float32)`` + ``segment_sum`` (dense engine)
     and ``torch.matmul`` on bfloat16 (``tile_matmul``); bounds at 3.35
     TB/s and 67 TFLOP/s FFMA (ELL) or 989 TFLOP/s bf16 (tensor cores);
 21. prints one ``{"kernels": [...]}`` line (with each kernel's ptxas
     registers and spills, the ragged kernel's tuned config at each
     class, each kernel's launches, device ms, bound and library call
     (the forward's, on Aᵀ's partition) in the training backward, and
     one ``<kernel>_bf16`` entry per kernel: its bfloat16
     instances' ptxas lines, their launches on the bfloat16 path and
     their times; the ragged entry also carries ``table_cases``: the
     kernel past 4 K bands, where it reads each unit's band K from a
     [U] table kept on the card, on the unpadded partitions of cora and
     pubmed reordered by labels (23 and 52 K runs, as training runs
     them), F = 128: bitwise its plain version and the 4-band launch at
     max_bands 8 and every run, at float32 and with bfloat16 B and vals;
     one table launch a call, the tables kept (none built again), the
     launches captured into CUDA graphs;
     device ms at 4 and 8 bands and every run beside the fixed-K kernel
     and ``torch.sparse.mm`` + ``index_add_``, with the K trips of each;
     and the ``coo_rows`` entry: the COO row kernel held bit for bit
     against its plain version (the unfused gather, product,
     ``segment_sum`` and add), with its own long-row length and with
     every row on each path, at the main path's COO shapes (cora,
     citeseer, pubmed; F = 128 and the class count; G = 1 and 4) and at
     synthetic ones shaped like the Reddit- and Flickr-sized graphs'
     COO (``COO_SHAPES``), timed beside its plain version, ``torch.sparse.mm`` over the live
     rows' CSR + ``index_add_``, its bound, every row on the short path
     and other long-row lengths, with its long rows and their
     entries; a spill of any of its instances fails the smoke)
     and, last, the ``{"ok": true, "device": ...}`` line.

Any failed check exits non-zero without the last line. Without CUDA, or
without the repository's sources, it exits non-zero and prints no result.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): device memory rate,
# float32 outside the tensor cores (the float32 kernels and the ELL
# kernels at every type run FFMA, no TF32) and bfloat16 on the tensor
# cores (the bfloat16 instances of bsr_spmm and tile_matmul).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

# The paper's model, as in src/repro/configs/gcn_paper.py CONFIG:
# 2-layer GCN, hidden 128; the output width is the dataset's n_classes.
HIDDEN = 128
GRAPHS = ("cora", "citeseer", "pubmed")
GROUP = 4
SEED = 0

KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)   # f32, one k order vs another
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)    # 1433-wide X·W, other sum order
# tile_matmul vs cuBLAS: |C - C_ref| <= atol + rtol * (|A| @ |B|), a
# multiple of the float32 rounding of K-term sums taken in two orders
MATMUL_TOL = dict(rtol=1e-5, atol=1e-6)
# The per-K A/B dispatches, and the pubmed scales (largest first) that
# land in one shape class for the lifecycle phase: pubmed@1.0 founds a
# 512 x 512-tile class; 0.78 and 0.71 (241 and 219 row tiles) join it,
# and its retirement moves them into a 256 x 256-tile successor.
AB_DISPATCHES = ("fused", "loop")
LIFECYCLE_SCALES = (1.0, 0.78, 0.71)
LIFECYCLE_DISPATCHES = ("ragged", "fused")
LAYERS = 2
# Serving phase: a deadline this long never closes a batch early, so each
# graph's GROUP requests close as one batch of GROUP (by size).
SERVE_DEADLINE_MS = 60_000.0
SERVE_TIMEOUT_S = 120.0
TIMING_REPS = 30
GRAPH_CALLS = 20
# device kernels counted by name in the profile of one infer
PROFILE_NAMES = {"bsr_rows_kernel": "bsr_rows_kernel",
                 "ell_rows_kernel": "ell_rows_kernel",
                 "ell_band_kernel": "ell_band_kernel",
                 "coo_rows_kernel": "coo_rows_kernel",
                 "segment_reduce": "segment_reduce",
                 "scan": "scan",
                 "index_select": "vectorized_gather",
                 "elementwise": "elementwise_kernel"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def max_err(a, b) -> float:
    return float((a - b).abs().max().item()) if a.numel() else 0.0


def close(a, b, rtol, atol) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all().item())


def matmul_close(torch, got, want, a, b) -> bool:
    bound = MATMUL_TOL["atol"] + MATMUL_TOL["rtol"] * torch.matmul(
        a.abs(), b.abs())
    return bool(((got - want).abs() <= bound).all().item())


def glorot(rng, fan_in: int, fan_out: int) -> np.ndarray:
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)


def call_ms(torch, fn) -> float:
    """Median CUDA-event time of one call issued from Python: the card
    waits for the host between the events, so this includes the
    wrapper's host overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn) -> float:
    """Device time of one call: GRAPH_CALLS calls captured in one CUDA
    graph, replayed TIMING_REPS times; median per call. Replaying keeps
    host overhead out, so this is the time the card spends."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_CALLS)
    return statistics.median(times)


def wall_ms(torch, fn) -> float:
    """Median host time of a call that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# contract_cost's bytes and operations against ell_bytes / band_bytes
COST_TOL = 0.01


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS_PER_S
          ) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops,
                                                          "operations")


def ptxas_summary(log: str) -> list:
    """One line per kernel of an nvcc ``-Xptxas -v`` log, as ptxas reports
    it: the entry's (mangled) name, its registers, static shared memory
    and spills."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


# ------------------------------------------------------------ main path ----
def main_path(torch):
    """Register the three graphs and serve each one infer and one group.

    Returns (engine, per-graph records, launch counts of the run).
    """
    from repro_torch.data.graphs import PAPER_DATASETS, make_paper_dataset
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED)
    engine = Engine(device="cuda")
    graphs = {}
    ops.reset_launch_counts()
    for name in GRAPHS:
        st = PAPER_DATASETS[name]
        csr, x0, _, _ = make_paper_dataset(name, scale=1.0, seed=SEED)
        ws = [glorot(rng, st.n_features, HIDDEN),
              glorot(rng, HIDDEN, st.n_classes)]
        t0 = time.perf_counter()
        engine.register(name, csr, weights=ws)
        reg_s = time.perf_counter() - t0
        xs = [x0] + [(rng.random(x0.shape) < 0.05).astype(np.float32)
                     for _ in range(GROUP - 1)]
        c0 = ops.launch_counts()
        y_infer = engine.infer(name, xs[0])
        torch.cuda.synchronize()
        c1 = ops.launch_counts()
        y_group = engine.serve_group([(name, x) for x in xs])
        torch.cuda.synchronize()
        c2 = ops.launch_counts()
        graphs[name] = dict(
            csr=csr, n=csr.shape[0], classes=st.n_classes, ws=ws, xs=xs,
            register_s=reg_s, y_infer=y_infer, y_group=y_group,
            infer_launches={k: c1[k] - c0[k] for k in c0},
            group_launches={k: c2[k] - c1[k] for k in c0})
    return engine, graphs, ops.launch_counts()


def check_main_path(torch, engine, graphs, counts) -> list:
    from repro_torch.engine import Engine

    problems = []
    ref = Engine(device="cuda", backend="torch")
    layers = LAYERS
    for name, g in graphs.items():
        ref.register(name, g["csr"], weights=g["ws"])
        want_shape = (g["n"], g["classes"])
        outs = [g["y_infer"]] + list(g["y_group"])
        for y in outs:
            if tuple(y.shape) != want_shape:
                problems.append(f"{name}: logits shape {tuple(y.shape)}")
            if not bool(torch.isfinite(y).all()):
                problems.append(f"{name}: non-finite logits")
        coo = layers if engine.handle(name).sclass.coo_nnz else 0
        for kind in ("infer_launches", "group_launches"):
            if g[kind] != {"bsr_spmm": layers, "ragged_ell_spmm": layers,
                           "ell_spmm": 0, "tile_matmul": 0,
                           "coo_rows": coo}:
                problems.append(f"{name}: {kind} {g[kind]}, want one of "
                                f"each kernel per layer")
        y_ref = ref.infer(name, g["xs"][0])
        g["err_vs_torch"] = max_err(g["y_infer"], y_ref)
        if not close(g["y_infer"], y_ref, **LOGIT_TOL):
            problems.append(f"{name}: infer vs torch backend "
                            f"max_abs_err {g['err_vs_torch']}")
        solo = [engine.infer(name, x) for x in g["xs"]]
        g["err_group_vs_infer"] = max(max_err(a, b)
                                      for a, b in zip(g["y_group"], solo))
        g["group_bitwise_infer"] = all(torch.equal(a, b)
                                       for a, b in zip(g["y_group"], solo))
        if not g["group_bitwise_infer"]:
            problems.append(f"{name}: serve_group not bitwise-equal to "
                            f"infer (max_abs_err {g['err_group_vs_infer']})")
        again = engine.serve_group([(name, x) for x in g["xs"]])
        if not (torch.equal(engine.infer(name, g["xs"][0]), g["y_infer"])
                and all(torch.equal(a, b)
                        for a, b in zip(again, g["y_group"]))):
            problems.append(f"{name}: repeat run not bitwise-equal")
        # host features (what a request brings) and features already on
        # the card (the forward alone)
        reqs = [(name, x) for x in g["xs"]]
        x_dev = torch.from_numpy(g["xs"][0]).cuda()
        g["infer_ms"] = wall_ms(torch, lambda: engine.infer(name, g["xs"][0]))
        g["infer_dev_ms"] = wall_ms(torch, lambda: engine.infer(name, x_dev))
        g["group_ms"] = wall_ms(torch, lambda: engine.serve_group(reqs))
    for k in ("bsr_spmm", "ragged_ell_spmm", "coo_rows"):
        if counts[k] == 0:
            problems.append(f"{k} never launched on the main path")
    return problems


# ------------------------------------------------------------- serving ----
def _resolve(futs) -> tuple:
    """(results, errors) of ``futs``, each waited for at most
    ``SERVE_TIMEOUT_S``; a future that raised or timed out leaves None
    and its exception."""
    outs, errs = [], []
    for f in futs:
        try:
            outs.append(f.result(timeout=SERVE_TIMEOUT_S))
            errs.append(None)
        except Exception as e:     # noqa: BLE001 — reported as a problem
            outs.append(None)
            errs.append(e)
    return outs, errs


def _serve(torch, queue, reqs, on_done=None) -> tuple:
    """Start ``queue``, submit ``reqs`` (host features), wait for every
    future, stop the queue. Returns (results, errors, wall seconds,
    stats snapshot)."""
    t0 = time.perf_counter()
    queue.start()
    try:
        futs = []
        for i, (name, x) in enumerate(reqs):
            f = queue.submit(name, x)
            if on_done is not None:
                f.add_done_callback(lambda _, i=i: on_done(i))
            futs.append(f)
        outs, errs = _resolve(futs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        queue.stop()
    return outs, errs, wall, queue.stats.snapshot()


def _mode_record(snap, wall, **extra) -> dict:
    keep = ("arrivals", "completed", "batches", "batch_hist",
            "close_reasons", "p50_ms", "p99_ms", "mean_latency_ms",
            "deadline_misses", "dispatch_errors", "inflight_peak",
            "overlap_ratio", "staging_p50_ms", "device_p50_ms",
            "resilience")
    rec = {k: snap[k] for k in keep}
    if "replicas" in snap:
        rec["replicas"] = {k: snap["replicas"][k]
                           for k in ("count", "faults", "key_epochs")}
        rec["routed"] = {r: v["routed"] for r, v in
                         snap["replicas"]["per_replica"].items()}
    return dict(rec, wall_s=wall, **extra)


def serving_phase(torch, engine, graphs, smi: str) -> tuple:
    """The serving front end over the main path's "ragged" engine.

    Four modes, each a ``RequestQueue`` over ``engine`` with its worker
    thread started, fed the main path's requests as host numpy features
    (``GROUP`` per graph, so each graph's requests share one key and
    close as one batch), the launch counters set to 0 just before each
    mode and read just after:

      serial     ``RequestQueue(engine, target_batch=GROUP)``. Gates:
                 every future resolves; results bitwise-equal to the main
                 path's ``serve_group`` of the same members (``y_group``)
                 and to per-request ``infer``; two
                 launches (one per layer) of ``ragged_ell_spmm`` per
                 batch and of ``bsr_spmm`` per batch on a class with
                 dense tiles; ``stats()["serving"]["completed"]`` equals
                 the submissions; each warm latency sample at least the
                 device ms of its dispatch (CUDA events around
                 ``serve_group_async``), so the queue timed the dispatch
                 and not its enqueue;
      pipelined  ``pipelined=True, max_inflight=4, stage_workers=1``:
                 results bitwise-equal to serial, the same launches;
      replicas   ``replicas=2`` (two ``replica_view`` lanes, private
                 executor caches, one card), the requests twice: results
                 bitwise-equal to serial, each graph's futures resolved
                 in submit order, the same launches per batch;
      chaos      a ``ChaosInjector`` poisons one request name (an alias
                 of cora in cora's batch): that future raises
                 ``PoisonedRequest``, its batch-mates, re-dispatched at
                 G = 2 and G = 1 by the quarantine bisection, are
                 bitwise-equal to serial (X·W runs one 2-D product per
                 member, so no result depends on the group size); then a
                 pipelined queue whose first dispatch hangs: the dispatch
                 watchdog reclaims it, the retry resolves every future
                 bitwise-equal to serial.

    Also times a warm one-request ``serve_group`` with the features on
    the card per graph: the least of these is what
    ``Engine.LAUNCH_FLOOR_S`` states.

    Returns (problems, record).
    """
    from repro_torch.kernels import ops
    from repro_torch.serving import (NULL_INJECTOR, ChaosInjector,
                                     FaultPlan, FaultSpec, PoisonedRequest,
                                     RequestQueue)

    problems, record = [], dict(gpu=smi)
    names = list(graphs)
    reqs = [(name, x) for name in names for x in graphs[name]["xs"]]
    dense = {name: bool(engine.handle(name).sclass.n_dense_tiles)
             for name in names}
    coo = {name: bool(engine.handle(name).sclass.coo_nnz) for name in names}

    def launch_problems(mode, counts, batches_by_graph):
        want = {"bsr_spmm": sum(LAYERS * n for g, n in
                                batches_by_graph.items() if dense[g]),
                "ragged_ell_spmm": LAYERS * sum(batches_by_graph.values()),
                "ell_spmm": 0, "tile_matmul": 0,
                "coo_rows": sum(LAYERS * n for g, n in
                                batches_by_graph.items() if coo[g])}
        if counts != want:
            return [f"serving {mode}: launches {counts}, want {want}"]
        return []

    def unresolved(mode, errs):
        bad = [repr(e) for e in errs if e is not None]
        return [f"serving {mode}: {len(bad)} futures failed: {bad[:3]}"] \
            if bad else []

    # -- serial, with each dispatch's device time and latency sample ----
    events, samples = [], []
    async_fn = engine.serve_group_async

    def timed(requests, prepared=None, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = async_fn(requests, prepared, **kw)
        end.record()
        events.append((start, end))
        return out

    engine.serve_group_async = timed
    try:
        queue = RequestQueue(engine, target_batch=GROUP,
                             default_deadline_ms=SERVE_DEADLINE_MS)
        observe = queue.latency.observe

        def record_sample(key, batch, dt_s=None, cold=False, **kw):
            samples.append((dt_s, cold))
            observe(key, batch, dt_s, cold, **kw)

        queue.latency.observe = record_sample
        ops.reset_launch_counts()
        serial, errs, wall, snap = _serve(torch, queue, reqs)
        counts = ops.launch_counts()
    finally:
        del engine.serve_group_async
    problems += unresolved("serial", errs)
    problems += launch_problems("serial", counts, {n: 1 for n in names})
    completed = engine.stats()["serving"]["completed"]
    if completed != len(reqs) or snap["batches"] != len(names):
        problems.append(f"serving serial: completed {completed}, batches "
                        f"{snap['batches']}; want {len(reqs)}, "
                        f"{len(names)}")
    bitwise, err_infer = True, 0.0
    for k, (name, x) in enumerate(reqs):
        y, want = serial[k], graphs[name]["y_group"][k % GROUP]
        if y is None:
            continue
        bitwise &= torch.equal(y, want)
        solo = engine.infer(name, x)
        err_infer = max(err_infer, max_err(y, solo))
        if not torch.equal(y, solo):
            problems.append(f"serving serial {name}: not bitwise-equal to "
                            f"infer (max_abs_err {max_err(y, solo)})")
    if not bitwise:
        problems.append("serving serial: results not bitwise-equal to "
                        "serve_group of the same members")
    torch.cuda.synchronize()
    dev_ms = [start.elapsed_time(end) for start, end in events]
    lat_ms = [dt * 1e3 for dt, _ in samples]
    warm = [not cold for _, cold in samples]
    if len(dev_ms) != len(samples) or not all(warm) or any(
            lat < dev for lat, dev in zip(lat_ms, dev_ms)):
        problems.append(f"serving serial: latency samples {lat_ms} ms "
                        f"(warm {warm}) against dispatch device times "
                        f"{dev_ms} ms")
    record["serial"] = _mode_record(
        snap, wall, launches=counts, bitwise_vs_serve_group=bitwise,
        max_abs_err_vs_infer=err_infer, latency_samples_ms=lat_ms,
        dispatch_device_ms=dev_ms)

    # -- pipelined -------------------------------------------------------
    queue = RequestQueue(engine, target_batch=GROUP,
                         default_deadline_ms=SERVE_DEADLINE_MS,
                         pipelined=True, max_inflight=4, stage_workers=1)
    ops.reset_launch_counts()
    outs, errs, wall, snap = _serve(torch, queue, reqs)
    counts = ops.launch_counts()
    problems += unresolved("pipelined", errs)
    problems += launch_problems("pipelined", counts, {n: 1 for n in names})
    same = all(a is not None and b is not None and torch.equal(a, b)
               for a, b in zip(outs, serial))
    if not same:
        problems.append("serving pipelined: results not bitwise-equal to "
                        "serial")
    record["pipelined"] = _mode_record(snap, wall, launches=counts,
                                       bitwise_vs_serial=same)

    # -- two replica lanes on the one card, the requests twice -----------
    done_order = []
    queue = RequestQueue(engine, target_batch=GROUP,
                         default_deadline_ms=SERVE_DEADLINE_MS, replicas=2)
    ops.reset_launch_counts()
    outs, errs, wall, snap = _serve(torch, queue, reqs + reqs,
                                    on_done=done_order.append)
    counts = ops.launch_counts()
    problems += unresolved("replicas", errs)
    problems += launch_problems("replicas", counts, {n: 2 for n in names})
    same = all(a is not None and b is not None and torch.equal(a, b)
               for a, b in zip(outs, serial + serial))
    in_order = all(
        [i for i in done_order if reqs[i % len(reqs)][0] == name]
        == sorted(i for i in done_order if reqs[i % len(reqs)][0] == name)
        for name in names) and len(done_order) == 2 * len(reqs)
    if not (same and in_order):
        problems.append(f"serving replicas: bitwise vs serial {same}, "
                        f"per-key order kept {in_order}")
    record["replicas"] = _mode_record(snap, wall, launches=counts,
                                      bitwise_vs_serial=same,
                                      per_key_order=in_order)

    # -- chaos: a poisoned request name, then a hung dispatch ------------
    cora = graphs["cora"]
    alias = "cora~"
    engine.register(alias, cora["csr"], weights=cora["ws"])
    poison_reqs = [("cora", cora["xs"][0]), ("cora", cora["xs"][1]),
                   (alias, cora["xs"][2]), ("cora", cora["xs"][3])]
    inj = ChaosInjector(FaultPlan([FaultSpec(site="poison", at=0,
                                             member=2)]))
    queue = RequestQueue(engine, target_batch=GROUP,
                         default_deadline_ms=SERVE_DEADLINE_MS,
                         injector=inj, resilience=True)
    try:
        outs, errs, wall, snap = _serve(torch, queue, poison_reqs)
    finally:
        engine.attach_injector(NULL_INJECTOR)
    base = names.index("cora") * GROUP
    mates = [k for k in range(GROUP) if k != 2]
    poisoned = isinstance(errs[2], PoisonedRequest)
    mates_bitwise = all(outs[k] is not None and torch.equal(
        outs[k], serial[base + k]) for k in mates)
    mates_err = max((max_err(outs[k], serial[base + k]) for k in mates
                     if outs[k] is not None), default=0.0)
    if not (poisoned and mates_bitwise
            and all(errs[k] is None for k in mates)):
        problems.append(f"serving chaos poison: poisoned future raised "
                        f"{errs[2]!r}; batch-mates bitwise-equal to serial "
                        f"{mates_bitwise} (max_abs_err {mates_err}), errors "
                        f"{[repr(e) for e in errs]}")
    record["chaos_poison"] = _mode_record(
        snap, wall, poisoned_raised=poisoned,
        mates_bitwise_vs_serial=mates_bitwise, fired=inj.fired())

    base = names.index("pubmed") * GROUP
    hang_reqs = reqs[base:base + GROUP]
    inj = ChaosInjector(FaultPlan([FaultSpec(site="hang", at=0)]))
    queue = RequestQueue(engine, target_batch=GROUP,
                         default_deadline_ms=SERVE_DEADLINE_MS,
                         pipelined=True, injector=inj, resilience=True)
    try:
        outs, errs, wall, snap = _serve(torch, queue, hang_reqs)
    finally:
        engine.attach_injector(NULL_INJECTOR)
    hang_bitwise = all(e is None for e in errs) and all(
        torch.equal(y, serial[base + k]) for k, y in enumerate(outs))
    fires = snap["resilience"]["watchdog_fires"]
    if not hang_bitwise or fires < 1 or queue.inflight():
        problems.append(f"serving chaos hang: watchdog fires {fires}, "
                        f"errors {[repr(e) for e in errs]}, bitwise-equal "
                        f"to serial {hang_bitwise}, in flight "
                        f"{queue.inflight()}")
    record["chaos_hang"] = _mode_record(
        snap, wall, bitwise_vs_serial=hang_bitwise, fired=inj.fired())

    # -- the latency prior's floor: warm one-request dispatches ----------
    one = {}
    for name in names:
        x_dev = torch.from_numpy(graphs[name]["xs"][0]).cuda()
        one[name] = wall_ms(torch, lambda: engine.serve_group([(name,
                                                                 x_dev)]))
    record["one_request_serve_group_dev_x_ms"] = one
    record["launch_floor_ms"] = engine.LAUNCH_FLOOR_S * 1e3
    return problems, record


REORDERED = {"cora@labels": "cora", "pubmed@labels": "pubmed"}


def reordered_phase(torch, engine, graphs) -> tuple:
    """More graphs on the main path: cora and pubmed at full size,
    reordered by their planted communities (``reorder(csr, "labels",
    labels=make_paper_dataset.last_labels)``, the paper workload's first
    step), registered on the main path's engine (``REORDERED``: each with
    its source graph's weights) and served one ``infer`` each, with the
    launch counters set to 0 just before and read just after each.

    Gates: the main path's launches, one per layer of each engine that
    the graph's shape class has (the reordering moves all of cora's
    dense tiles into the ELL engine, so its class may have none, and
    then ``bsr_spmm`` has no launch), and nothing else; logits finite,
    of the graph's shape, within ``LOGIT_TOL`` of the plain "torch"
    backend on the same reordered graph and, for cora, of the main
    path's unreordered cora logits (same weights and features; the
    engine returns rows in the graph's own order).

    Then ``bsr_spmm_rows`` once on the dense part of cora@labels' class,
    which has no tile: zeros of the row tiles' shape, and no launch.

    Returns (problems, cora@labels' record with a ``graphs`` list of
    every reordered graph's, launch counts of cora@labels' run).
    """
    from repro_torch.core.formats import b_tiles_of, plan_to, stack_plans
    from repro_torch.core.reorder import bandwidth, reorder
    from repro_torch.data.graphs import make_paper_dataset
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.kernels.bsr_spmm import bsr_spmm_rows

    problems, records = [], []
    ref = Engine(device="cuda", backend="torch")
    for name, src in REORDERED.items():
        g = graphs[src]
        csr, _, _, _ = make_paper_dataset(src, scale=1.0, seed=SEED)
        labels = make_paper_dataset.last_labels
        t0 = time.perf_counter()
        engine.register(name, csr, reorder="labels", labels=labels,
                        weights=g["ws"])
        register_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        y = engine.infer(name, g["xs"][0])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        sc = engine.handle(name).sclass
        want = {"bsr_spmm": LAYERS if sc.n_dense_tiles else 0,
                "ragged_ell_spmm": LAYERS if sc.ell_units else 0,
                "ell_spmm": 0, "tile_matmul": 0,
                "coo_rows": LAYERS if sc.coo_nnz else 0}
        if counts != want or counts["ragged_ell_spmm"] == 0:
            problems.append(f"{name}: launches {counts}, want {want}")
        if tuple(y.shape) != (g["n"], g["classes"]) or not bool(
                torch.isfinite(y).all()):
            problems.append(f"{name}: logits {tuple(y.shape)}, finite "
                            f"{bool(torch.isfinite(y).all())}")
        ref.register(name, csr, reorder="labels", labels=labels,
                     weights=g["ws"])
        y_ref = ref.infer(name, g["xs"][0])
        others = [("torch backend", y_ref)]
        if src == "cora":
            others.append(("unreordered graph", g["y_infer"]))
        for what, other in others:
            if not close(y, other, **LOGIT_TOL):
                problems.append(f"{name} vs {what}: max_abs_err "
                                f"{max_err(y, other)}")
        records.append(dict(
            graph=name, register_s=register_s, launches=counts,
            err_vs_torch=max_err(y, y_ref),
            bands=[list(b) for b in sc.bands],
            bandwidth=[bandwidth(csr), bandwidth(reorder(
                csr, "labels", labels=labels)[0])],
            shape_class=sc.summary(),
            main_path_class=engine.handle(src).sclass.summary()))
        if src == "cora":
            cora_counts, cora_y = counts, y
    name = "cora@labels"
    g = graphs["cora"]
    h = engine.handle(name)
    sc = h.sclass
    b = torch.matmul(engine.prepare_x(name, g["xs"][0]), h.weights[0])
    c0 = ops.launch_counts()["bsr_spmm"]
    empty = bsr_spmm_rows(
        h.part.dense.tiles[None], h.part.dense.tile_col[None],
        b_tiles_of(b[None], sc.to_meta()).contiguous(),
        plan_to(stack_plans([h.host_plan]), b.device).dense,
        device=b.device)
    torch.cuda.synchronize()
    empty_ok = (not sc.n_dense_tiles
                and tuple(empty.shape) == (1, sc.n_row_tiles, sc.tile,
                                           b.shape[1])
                and not bool(empty.any())
                and ops.launch_counts()["bsr_spmm"] == c0)
    if not empty_ok:
        problems.append(f"{name}: bsr_spmm_rows on the class's dense part "
                        f"({sc.n_dense_tiles} tiles) gave "
                        f"{tuple(empty.shape)}, nonzero "
                        f"{int(empty.count_nonzero())}, launches "
                        f"{ops.launch_counts()['bsr_spmm'] - c0}")
    record = dict(records[0], empty_dense_zeros=empty_ok,
                  err_vs_unreordered=max_err(cora_y, g["y_infer"]),
                  graphs=records)
    return problems, record, cora_counts


def profile_calls(torch, fn, calls: int = 5, cpu: bool = True,
                  detail: bool = False) -> dict:
    """Device time of one call of ``fn``, from a ``torch.profiler`` trace
    of ``calls`` calls: kernels per call, device ms per call, the
    device's busy share of the traced wall time, launches per call of the
    kernels in ``PROFILE_NAMES``, and the kernels that take the most
    device time. A trace with no device event at all is a lost
    measurement and is taken again, up to ``launch_pass.PROFILE_TRIES``
    traces; the last is returned whatever it holds. ``cpu=False`` traces
    the device alone (for calls of tens of thousands of kernels);
    ``detail`` adds every kernel's device ms and launches per call
    (``per_kernel``, ``per_kernel_calls``)."""
    from repro_torch.analysis.static.launch_pass import PROFILE_TRIES

    for _ in range(PROFILE_TRIES):
        prof = _profile_calls_once(torch, fn, calls, cpu, detail)
        if prof["kernels_per_infer"]:
            break
    return prof


def _profile_calls_once(torch, fn, calls: int, cpu: bool = True,
                        detail: bool = False) -> dict:
    """One profile for ``profile_calls``. The trace is the profiler's
    second step: the first, a warm-up step of the same calls, is
    discarded, because kernels of the first calls after the profiler
    starts may go unrecorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    traced = []
    activities = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(list(p.events()))
                 ) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    per_kernel, per_calls, launches = {}, {}, 0
    by_name = dict.fromkeys(PROFILE_NAMES, 0)
    for e in traced[-1]:
        # the step's own annotation spans the step on the device too
        if (e.device_type == DeviceType.CUDA
                and not e.name.startswith("ProfilerStep")):
            launches += 1
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
            per_calls[e.name] = per_calls.get(e.name, 0) + 1
            for key, pattern in PROFILE_NAMES.items():
                by_name[key] += pattern in e.name.lower()
    busy_us = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = dict(kernels_per_infer=launches / calls,
               device_ms_per_infer=busy_us / calls / 1e3,
               busy_share=busy_us / wall_us if wall_us else 0.0,
               launches_per_infer={k: v / calls for k, v in by_name.items()},
               top=[[k[:60], v / calls / 1e3] for k, v in top])
    if detail:
        out["per_kernel"] = {k: v / calls / 1e3 for k, v in per_kernel.items()}
        out["per_kernel_calls"] = {k: v / calls for k, v in per_calls.items()}
    return out


def copy_sources(torch, fn, calls: int = 3) -> dict:
    """Where a call's device-to-device copies come from: device ms per
    call of the ``Memcpy DtoD`` work launched under each CPU op (with its
    input shapes and two callers), from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            if "Memcpy DtoD" not in k.name:
                continue
            chain, up = [f"{e.name}{e.input_shapes}"], e.cpu_parent
            while up is not None and len(chain) < 3:
                chain.append(up.name)
                up = up.cpu_parent
            key = " < ".join(chain)
            out[key] = out.get(key, 0.0) + k.duration / calls / 1e3
    return out


# -------------------------------------------------------- dispatch A/B ----
def dispatch_ab(torch, graphs) -> tuple:
    """Serve the main path's requests through ``Engine(ell_dispatch=d)``
    for each per-K dispatch, with the launch counters set to 0 just
    before each dispatch's run and read just after; then profile one
    ``infer`` per graph beside the ragged dispatch's profile
    (``graphs[name]["profile"]``).

    Gates: one ``ell_spmm`` launch per layer (for every class band) and
    no ``ragged_ell_spmm``; logits bit for bit equal to the ragged
    dispatch's; repeats bitwise; in the profile, the band kernel and no
    ``ell_rows_kernel`` on the ELL part, and no gather,
    ``segment_reduce``, scan or elementwise kernel beyond the ragged
    dispatch's (``profile_problems``).

    Returns (problems, per-(dispatch, graph) records, launch counts of
    each dispatch's run).
    """
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops

    problems, rows, per_dispatch = [], [], {}
    for d in AB_DISPATCHES:
        engine = Engine(device="cuda", ell_dispatch=d)
        register_s = {}
        for name, g in graphs.items():
            t0 = time.perf_counter()
            engine.register(name, g["csr"], weights=g["ws"])
            register_s[name] = time.perf_counter() - t0
        outs = {}
        ops.reset_launch_counts()
        for name, g in graphs.items():
            sc = engine.handle(name).sclass
            bands = len(sc.bands)
            want = {"bsr_spmm": LAYERS, "ragged_ell_spmm": 0,
                    "ell_spmm": LAYERS, "tile_matmul": 0,
                    "coo_rows": LAYERS if sc.coo_nnz else 0}
            c0 = ops.launch_counts()
            y = engine.infer(name, g["xs"][0])
            torch.cuda.synchronize()
            c1 = ops.launch_counts()
            ys = engine.serve_group([(name, x) for x in g["xs"]])
            torch.cuda.synchronize()
            c2 = ops.launch_counts()
            for kind, a, b in (("infer", c0, c1), ("serve_group", c1, c2)):
                got = {k: b[k] - a[k] for k in a}
                if got != want:
                    problems.append(f"{d} {name} {kind}: launches {got}, "
                                    f"want {want}")
            outs[name] = (y, ys, bands)
        counts = per_dispatch[d] = ops.launch_counts()
        for name, g in graphs.items():
            y, ys, bands = outs[name]
            pairs = [(y, g["y_infer"])] + list(zip(ys, g["y_group"]))
            bitwise = all(torch.equal(a, b) for a, b in pairs)
            err = max(max_err(a, b) for a, b in pairs)
            if not bitwise:
                problems.append(f"{d} {name}: logits not bitwise-equal to "
                                f"the ragged dispatch (max_abs_err {err})")
            again = [engine.infer(name, g["xs"][0])] + engine.serve_group(
                [(name, x) for x in g["xs"]])
            if not all(torch.equal(a, b) for a, b in zip(again, [y] + ys)):
                problems.append(f"{d} {name}: repeat not bitwise-equal")
            x_dev = torch.from_numpy(g["xs"][0]).cuda()
            prof = profile_calls(torch, lambda: engine.infer(name, x_dev))
            problems += profile_problems(f"{d} {name}", prof, g["profile"])
            rows.append(dict(
                dispatch=d, graph=name, bands=bands,
                register_s=register_s[name],
                bitwise_vs_ragged=bitwise, max_abs_err_vs_ragged=err,
                infer_ms=wall_ms(torch, lambda: engine.infer(name,
                                                             g["xs"][0])),
                infer_dev_ms=wall_ms(torch, lambda: engine.infer(name,
                                                                 x_dev)),
                ragged_infer_ms=g["infer_ms"],
                ragged_infer_dev_ms=g["infer_dev_ms"],
                profile={k: prof[k] for k in ("kernels_per_infer",
                                              "device_ms_per_infer",
                                              "busy_share",
                                              "launches_per_infer")},
                ragged_profile={k: g["profile"][k] for k in (
                    "kernels_per_infer", "device_ms_per_infer")}))
        if counts["ell_spmm"] == 0 or counts["ragged_ell_spmm"] != 0:
            problems.append(f"{d}: launches {counts}")
    return problems, rows, per_dispatch


def profile_problems(what, prof, ragged) -> list:
    """A per-K dispatch's profile of one infer against the ragged
    dispatch's: its ELL part is the band kernel alone, at most one per
    layer. A profile may miss or add a stray event, so the other kernels
    by name may exceed "ragged"'s by less than one per infer: the chain
    the band kernel replaces launched a gather and a ``segment_reduce``
    per layer."""
    got, base = prof["launches_per_infer"], ragged["launches_per_infer"]
    problems = []
    if got["ell_rows_kernel"] or not 0 < got["ell_band_kernel"] <= LAYERS:
        problems.append(f"{what}: ELL kernels per infer {got}, want only "
                        f"ell_band_kernel, {LAYERS} per infer")
    extra = {k: got[k] - base[k] for k in got
             if k not in ("ell_rows_kernel", "ell_band_kernel")
             and got[k] - base[k] >= 1}
    if extra:
        problems.append(f"{what}: kernels per infer beyond the ragged "
                        f"dispatch's: {extra} (got {got}, ragged {base})")
    return problems


# ----------------------------------------------------------- lifecycle ----
def lifecycle_inputs(torch) -> dict:
    """The lifecycle phase's graphs, weights, features and spmm inputs."""
    from repro_torch.data.graphs import PAPER_DATASETS, make_paper_dataset

    rng = np.random.default_rng(SEED + 1)
    st = PAPER_DATASETS["pubmed"]
    ws = [glorot(rng, st.n_features, HIDDEN),
          glorot(rng, HIDDEN, st.n_classes)]
    graphs = {}
    for s in LIFECYCLE_SCALES:
        csr, x, _, _ = make_paper_dataset("pubmed", scale=s, seed=SEED)
        b = torch.from_numpy(rng.standard_normal(
            (csr.shape[0], HIDDEN)).astype(np.float32)).cuda()
        graphs[f"pubmed@{s}"] = (csr, x, b)
    return dict(ws=ws, graphs=graphs)


def lifecycle_phase(torch, inputs, dispatch) -> tuple:
    """Retire a shape class of three pubmed-shaped graphs on the card,
    on an ``Engine(ell_dispatch=dispatch)``.

    Returns (problems, record, launch counts of the phase).
    """
    from repro_torch.engine import Engine, LifecycleConfig, LifecycleManager
    from repro_torch.kernels import ops

    engine = Engine(device="cuda", ell_dispatch=dispatch)
    xs, bs = {}, {}
    for name, (csr, x, b) in inputs["graphs"].items():
        engine.register(name, csr, weights=inputs["ws"])
        xs[name], bs[name] = x, b
    classes = {engine.handle(n).sclass for n in xs}
    if len(classes) != 1:
        return [f"lifecycle {dispatch}: scales {LIFECYCLE_SCALES} fall "
                f"in {len(classes)} shape classes, not one"], {}, {}
    (sc,) = classes
    problems = []
    ops.reset_launch_counts()
    pre_spmm = {n: engine.spmm(n, b) for n, b in bs.items()}
    pre_infer = {n: engine.infer(n, x) for n, x in xs.items()}
    torch.cuda.synchronize()
    mgr = LifecycleManager(engine, config=LifecycleConfig(
        waste_budget=0.0, breach_windows=1, min_traffic=1))
    t0 = time.perf_counter()
    window = mgr.step()
    torch.cuda.synchronize()
    retire_s = time.perf_counter() - t0
    post_spmm = {n: engine.spmm(n, b) for n, b in bs.items()}
    post_infer = {n: engine.infer(n, x) for n, x in xs.items()}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if len(window["retired"]) != 1:
        problems.append(f"lifecycle {dispatch}: window retired {window['retired']}, "
                        f"skipped {window['skipped']}")
    if mgr.executors_invalidated < 1:
        problems.append(f"lifecycle {dispatch}: no executor invalidated")
    members = []
    for n in xs:
        succ = engine.handle(n).sclass
        spmm_bitwise = torch.equal(post_spmm[n], pre_spmm[n])
        infer_err = max_err(post_infer[n], pre_infer[n])
        members.append(dict(
            graph=n, rows=int(pre_infer[n].shape[0]),
            successor=succ.summary(),
            ell_mac_capacity=[sc.ell_mac_capacity, succ.ell_mac_capacity],
            n_padded_rows=[sc.n_row_tiles * sc.tile,
                           succ.n_row_tiles * succ.tile],
            spmm_bitwise=spmm_bitwise,
            spmm_max_abs_err=max_err(post_spmm[n], pre_spmm[n]),
            infer_bitwise=torch.equal(post_infer[n], pre_infer[n]),
            infer_max_abs_err=infer_err))
        if succ == sc or succ.ell_mac_capacity >= sc.ell_mac_capacity:
            problems.append(f"lifecycle {dispatch} {n}: successor "
                            f"{succ.summary()} is not tighter than "
                            f"{sc.summary()}")
        if not spmm_bitwise:
            problems.append(f"lifecycle {dispatch} {n}: spmm changed "
                            "across the retirement")
        if not close(post_infer[n], pre_infer[n], **LOGIT_TOL):
            problems.append(f"lifecycle {dispatch} {n}: infer max_abs_err "
                            f"{infer_err}")
    if not any(m["n_padded_rows"][1] < m["n_padded_rows"][0]
               for m in members):
        problems.append(f"lifecycle {dispatch}: no successor has fewer "
                        "padded rows than the retired class")
    # a replica view serves the successor class as the engine does
    keys = {}
    for n, x in xs.items():
        keys.setdefault(engine.group_key(n, x), []).append(n)
    group_names = max(keys.values(), key=len)
    group = [(n, xs[n]) for n in group_names] * 2
    want = engine.serve_group(group)
    got = engine.replica_view(0).serve_group(group)
    view_bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    if not view_bitwise:
        problems.append(f"lifecycle {dispatch}: replica view serve_group "
                        "differs from the engine's")
    ell_kernel = "ragged_ell_spmm" if dispatch == "ragged" else "ell_spmm"
    other = "ell_spmm" if dispatch == "ragged" else "ragged_ell_spmm"
    if counts["bsr_spmm"] == 0 or counts[ell_kernel] == 0 or counts[other]:
        problems.append(f"lifecycle {dispatch}: launches {counts}")
    record = dict(dispatch=dispatch, retired=window["retired"],
                  retire_s=retire_s,
                  executors_invalidated=mgr.executors_invalidated,
                  replica_group=len(group), replica_bitwise=view_bitwise,
                  launches=counts, members=members)
    return problems, record, counts


# --------------------------------------------------------- matmul path ----
def matmul_path(torch, engine, graphs) -> tuple:
    """The main path's X·W products of both layers through
    ``kernels.ops.matmul``, counters set to 0 before and read after.

    Returns (problems, [(graph, layer, A, B)], launch counts).
    """
    from repro_torch.kernels import ops

    problems, cases = [], []
    ops.reset_launch_counts()
    for name, g in graphs.items():
        h = engine.handle(name)
        a1 = engine.prepare_x(name, g["xs"][0])
        c1 = ops.matmul(a1, h.weights[0])
        a2 = torch.relu(c1)
        c2 = ops.matmul(a2, h.weights[1])
        torch.cuda.synchronize()
        for layer, a, w, c in ((1, a1, h.weights[0], c1),
                               (2, a2, h.weights[1], c2)):
            want = torch.matmul(a, w)
            if tuple(c.shape) != tuple(want.shape) or not matmul_close(
                    torch, c, want, a, w):
                problems.append(f"ops.matmul {name} layer {layer}: "
                                f"max_abs_err {max_err(c, want)}")
            cases.append((name, layer, a, w))
    counts = ops.launch_counts()
    if counts["tile_matmul"] != LAYERS * len(graphs):
        problems.append(f"matmul path: launches {counts}")
    return problems, cases, counts


# ----------------------------------------------------------------- X·W ----
def xw_phase(torch, engine, graphs) -> tuple:
    """What X·W as one 2-D product per group member costs against one
    batched product, at each graph's 4-request group: layer 1 ([4, N,
    F_in] @ [4, F_in, 128]) and layer 2 ([4, N, 128] @ [4, 128, C]),
    device ms per call (CUDA graphs); and whether the batched product's
    members are bitwise-equal to the 2-D products (where they are not,
    a member's bits would depend on its group's size).

    Gate: the per-member product of each member bitwise-equal to that
    member's own 2-D ``torch.matmul``. Returns (problems, records).
    """
    from repro_torch.core.hybrid_spmm import member_matmul

    problems, rows = [], []
    for name, g in graphs.items():
        h = engine.handle(name)
        x = torch.stack([engine.prepare_x(name, xi) for xi in g["xs"]])
        w1 = torch.stack([h.weights[0]] * GROUP)
        h1 = torch.relu(member_matmul(x, w1))
        w2 = torch.stack([h.weights[1]] * GROUP)
        for layer, a, w in ((1, x, w1), (2, h1, w2)):
            per = member_matmul(a, w)
            batched = torch.matmul(a, w)
            own = all(torch.equal(per[i], torch.matmul(a[i], w[i]))
                      for i in range(GROUP))
            if not own:
                problems.append(f"X·W {name} layer {layer}: a member's "
                                "product differs from its own 2-D product")
            rows.append(dict(
                graph=name, layer=layer, shape=list(a.shape) + [w.shape[-1]],
                per_member_ms=device_ms(torch, lambda: member_matmul(a, w)),
                batched_ms=device_ms(torch, lambda: torch.matmul(a, w)),
                batched_bitwise_per_member=torch.equal(batched, per)))
            print(f"  X·W {name} layer {layer}: " + json.dumps(rows[-1]))
    return problems, rows


# ------------------------------------------------------------ autotune ----
def class_case(torch, engine, name, x, f):
    """The ragged kernel's inputs at one member of ``name``'s class as the
    main path gives them at width ``f``: B = X·W1 at the hidden width,
    relu(X·W1)·W2 (layer 2's B has its shape and scale) at the output
    width, and the dense engine's rows to add onto. Returns (cols, vals,
    tile_col, unit_k, B tiles, ELL plan, dense rows)."""
    from repro_torch.core.formats import b_tiles_of, plan_to, stack_plans
    from repro_torch.kernels import ops

    h = engine.handle(name)
    meta = h.sclass.to_meta()
    b = torch.matmul(engine.prepare_x(name, x), h.weights[0])
    if f != b.shape[1]:
        b = torch.matmul(torch.relu(b), h.weights[1])
    part = type(h.part)(*(type(c)(*(a[None] for a in c)) for c in h.part))
    plan = plan_to(stack_plans([h.host_plan]), b.device)
    yd = ops.dense_tiles_matmul(part, b[None], meta, plan)
    e = part.ell
    return (e.cols, e.vals, e.tile_col, e.unit_k,
            b_tiles_of(b[None], meta).contiguous(), plan.ell, yd)


def autotune_phase(torch, engine, graphs, names) -> tuple:
    """``Engine.autotune`` on the main path's engine for the class of each
    graph in ``names`` (cora's is citeseer's too), at the hidden width and
    at the graph's output width, with the device timer (CUDA graphs of
    the tuned launch on the graph's own class-padded rows).

    Gates: the sweep times every candidate the contract audit passes and
    no other; every timed candidate's ``ragged_ell_rows`` is bitwise-equal
    to the default launch shape's on the class's real inputs at that
    width; the winner is what the class's launches of that width run;
    ``infer`` after tuning is bitwise-equal to the untuned ``infer``; a
    second ``autotune`` of the same (class, width) is a cache hit that
    times nothing. Then, per graph, the device ms of the GCN forward in
    its applied tuning against the defaults (CUDA graphs; default,
    tuned, tuned, default).

    Returns (problems, per-(graph, width) records, per-graph forward
    records); prints each sweep's per-candidate device ms, rejected
    candidates with their findings.
    """
    from repro_torch.core.hybrid_spmm import gcn_forward
    from repro_torch.kernels.ell_spmm import ragged_ell_rows, resolve_tune

    problems, rows = [], []
    xs = {n: graphs[n.split("@")[0]]["xs"][0] for n in names}
    untuned = {n: engine.infer(n, xs[n]) for n in names}
    for name in names:
        h = engine.handle(name)
        for f in (HIDDEN, int(h.weights[-1].shape[1])):
            t0 = time.perf_counter()
            cfg = engine.autotune(name, f)
            sweep_s = time.perf_counter() - t0
            tuner = engine.autotuner
            sweep = list(tuner.last_sweep)
            st0 = engine.stats()["autotune"]
            timed = [r for r in sweep if r["ms"] is not None]
            rejected = [r for r in sweep if r["ms"] is None]
            if any(r["ms"] is None and not any(
                    "ERROR" in x for x in r["findings"]) for r in sweep):
                problems.append(f"autotune {name} f={f}: a candidate "
                                "without an audit error was not timed")
            case = class_case(torch, engine, name, xs[name], f)
            dev = case[4].device
            segs = tuple(h.sclass.bands)
            want = ragged_ell_rows(*case[:6], case[6].clone(),
                                   segments=segs, device=dev)
            diff = [r["config"] for r in timed if not torch.equal(
                ragged_ell_rows(*case[:6], case[6].clone(), segments=segs,
                                tune=r["config"], device=dev), want)]
            applied = engine.executors.tuned_for(h.sclass, f)
            if applied != cfg:
                problems.append(f"autotune {name} f={f}: winner {cfg} but "
                                f"the class runs {applied} at f={f}")
            y = engine.infer(name, xs[name])
            infer_bitwise = torch.equal(y, untuned[name])
            again = engine.autotune(name, f)
            st1 = engine.stats()["autotune"]
            cached = (again == cfg and st1["hits"] == st0["hits"] + 1
                      and st1["timed"] == st0["timed"])
            if diff or not infer_bitwise or not cached or not timed:
                problems.append(
                    f"autotune {name} f={f}: candidates not bitwise-equal "
                    f"to the default {diff}; tuned infer bitwise "
                    f"{infer_bitwise}; second call a cache hit with timed "
                    f"unchanged {cached}; {len(timed)} timed")
            default = resolve_tune(f)
            default_ms = next((r["ms"] for r in timed
                               if r["effective"] == default), None)
            winner_ms = min(r["ms"] for r in timed) if timed else None
            print(f"autotune {name} f={f} [{h.sclass.summary()}]: winner "
                  f"{cfg} {winner_ms} ms, default {default} {default_ms} "
                  f"ms; {len(timed)} timed, {len(rejected)} rejected, "
                  f"{sweep_s:.2f} s")
            for r in sweep:
                eff = r["effective"]
                what = ("REJECTED " + "; ".join(x for x in r["findings"]
                                               if "ERROR" in x)
                        if r["ms"] is None else f"{r['ms']:.5f} ms")
                print(f"    w={eff['w']:2d} vec={eff['vec']} kc={eff['kc']} "
                      f"threads={eff['threads']:3d} max_bands="
                      f"{eff['max_bands']} ({r['bands']} bands)  {what}")
            rows.append(dict(
                graph=name, shape_class=h.sclass.summary(), f=f,
                winner=cfg, winner_ms=winner_ms, default=default,
                default_ms=default_ms,
                default_over_winner=(default_ms / winner_ms
                                     if default_ms and winner_ms else None),
                timed=len(timed), rejected=len(rejected), sweep_s=sweep_s,
                candidates_bitwise=not diff, infer_bitwise=infer_bitwise,
                second_call_cached=cached))
    forward = []
    for name in names:
        h = engine.handle(name)
        meta = h.sclass.to_meta()
        x = engine.prepare_x(name, torch.from_numpy(xs[name]).cuda())
        table = engine.executors.tuned().get(h.sclass, {})

        def fwd(tune):
            return lambda: gcn_forward(h.part, x, h.weights, meta=meta,
                                       plan=h.plan, ell_tune=tune,
                                       device="cuda")
        ms = {"default": [], "tuned": []}
        for which in ("default", "tuned", "tuned", "default"):
            ms[which].append(device_ms(torch, fwd(
                table if which == "tuned" else None)))
        forward.append(dict(graph=name, tuning=table,
                            default_ms=ms["default"], tuned_ms=ms["tuned"]))
        print(f"autotune forward {name}: default {ms['default']} ms, "
              f"tuned {ms['tuned']} ms ({table})")
    return problems, rows, forward


def lint_phase(torch, engine, graphs, names) -> tuple:
    """The three lint passes on the card, as ``python -m
    repro_torch.analysis.static --device cuda`` runs them (the fixture
    engine; the kernel pass reads the build's ptxas logs, the launch pass
    profiles the forward), then the launch and kernel passes over the
    main path's engine: each graph in ``names`` through its real
    executor, and every contract its classes imply in their applied
    tuning at the hidden width and every graph's output width. Gate: no
    unwaived error.

    Returns (problems, record).
    """
    from repro_torch.analysis.static.__main__ import main as lint_main
    from repro_torch.analysis.static.kernel_pass import run_kernel_pass
    from repro_torch.analysis.static.launch_pass import run_launch_pass

    problems = []
    rc = lint_main(["--device", "cuda", "-v"])
    if rc:
        problems.append(f"lint: python -m repro_torch.analysis.static "
                        f"exited {rc}")
    widths = sorted({HIDDEN} | {g["classes"] for g in graphs.values()})
    findings = run_kernel_pass(engine, f_widths=widths)
    for name in names:
        findings += run_launch_pass(engine, name)
    errors = [f for f in findings if f.severity == "error" and not f.waived]
    for line in dict.fromkeys(f.render() for f in findings):
        print("  " + line)
    problems += [f"lint on the main path: {f.render()}" for f in errors]
    return problems, dict(cli_exit=rc, main_path_findings=len(findings),
                          main_path_errors=len(errors))


# ------------------------------------------------------------ training ----
# The paper's training run (examples/quickstart.py): cora reordered by its
# planted labels, hidden 128, AdamW(5e-3, wd 1e-4), 60 steps; pubmed in
# its natural order (dense + ELL + COO) for 20.
# (graph, reorder, steps, whether the "it learns" gate applies)
TRAIN_GRAPHS = (("cora", "labels", 60, True), ("pubmed", None, 20, False))
RERUN_STEPS = 5
# first-step weight gradients, "cuda" vs "torch" backend on the card:
# |g - g_ref| <= atol_frac * max|g_ref| + rtol * |g_ref| (float32: the
# dense engine sums each tile's 64 products in another order, and the
# loss's gradient flows through both layers' sums)
GRAD_TOL = dict(rtol=2e-4, atol_frac=2e-5)


def _diff(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def grads_close(got, want) -> bool:
    for a, b in zip(got, want):
        atol = GRAD_TOL["atol_frac"] * float(b.abs().max())
        if not bool(((a - b).abs() <= atol + GRAD_TOL["rtol"] * b.abs())
                    .all()):
            return False
    return True


def train_grads(torch, data, ws, **kw):
    """(loss, weight gradients, forward launches, backward launches) of
    one ``hybrid_gcn_loss`` and its ``torch.autograd.grad``, with the
    quickstart's forward arguments and ``kw`` (backend, ell_dispatch)."""
    from repro_torch.examples import quickstart as qs
    from repro_torch.kernels import ops
    from repro_torch.train.steps import hybrid_gcn_loss

    leaves = [w.detach().requires_grad_(True) for w in ws]
    batch = {"x": data["x"], "labels": data["y"], "mask": data["train"]}
    c0 = ops.launch_counts()
    loss = hybrid_gcn_loss(leaves, batch, part=data["part"],
                           **qs.forward_kw(data, **kw))
    torch.cuda.synchronize()
    c1 = ops.launch_counts()
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return float(loss.detach()), grads, _diff(c0, c1), _diff(
        c1, ops.launch_counts())


def counted_step(torch, opt, ws, state, batch, data):
    """One step of ``make_hybrid_gcn_train_step`` written out as its
    ``value_and_grad`` and ``opt.update`` do it, with the launch counters
    read around the forward and around the backward. Returns (weights,
    state, loss, forward launches, backward launches)."""
    from repro_torch.examples import quickstart as qs
    from repro_torch.kernels import ops
    from repro_torch.train.steps import hybrid_gcn_loss

    leaves = [w.detach().requires_grad_(True) for w in ws]
    c0 = ops.launch_counts()
    loss = hybrid_gcn_loss(leaves, batch, part=data["part"],
                           **qs.forward_kw(data))
    c1 = ops.launch_counts()
    grads = torch.autograd.grad(loss, leaves)
    c2 = ops.launch_counts()
    ws, state = opt.update(list(grads), state, ws)
    return ws, state, loss.detach(), _diff(c0, c1), _diff(c1, c2)


def csr_grads(torch, data, ws):
    """The first step's weight gradients of the same loss with the
    product taken by ``torch.sparse`` CSR tensors built straight from
    the graph's CSR: A forward, and scipy's own transpose of it
    backward. Independent of the partitions, of ``transpose_partition``
    and of ``HybridSpmmFn``: the check that catches a wrong Aᵀ."""
    from repro_torch.core.formats import csr_to_scipy
    from repro_torch.train.steps import masked_xent

    dev = data["device"]

    def on_card(m):
        m = m.tocsr()
        return torch.sparse_csr_tensor(
            torch.from_numpy(m.indptr.astype(np.int64)),
            torch.from_numpy(m.indices.astype(np.int64)),
            torch.from_numpy(m.data.astype(np.float32)), size=m.shape,
            device=dev, check_invariants=True)

    csr = csr_to_scipy(data["csr"])
    a, at = on_card(csr), on_card(csr.T)

    class Product(torch.autograd.Function):
        @staticmethod
        def forward(ctx, b):
            return a @ b

        @staticmethod
        def backward(ctx, dy):
            return at @ dy

    leaves = [w.detach().requires_grad_(True) for w in ws]
    h = data["x"]
    for i, w in enumerate(leaves):
        h = Product.apply(h @ w)
        if i < len(leaves) - 1:
            h = torch.relu(h)
    return torch.autograd.grad(masked_xent(h, data["y"], data["train"]),
                               leaves)


def _want_launches(meta, dispatch: str) -> dict:
    """One launch of each path kernel per layer (the fixed-K kernel's for
    every K bucket) over a partition of ``meta``."""
    ell = len(meta.ell_segments) > 0
    return {"bsr_spmm": LAYERS * (meta.n_dense_tiles > 0),
            "ragged_ell_spmm": LAYERS * (dispatch == "ragged" and ell),
            "ell_spmm": LAYERS * (dispatch != "ragged" and ell),
            "tile_matmul": 0, "coo_rows": LAYERS * (meta.nnz_coo > 0)}


def asymmetric_pubmed(torch, dev):
    """Pubmed's pattern in its natural order with a random value per edge
    (seeded): A is not symmetric, so its backward needs Aᵀ's own
    partition. Returns quickstart-style data for it."""
    import scipy.sparse as sp

    from repro_torch.core.formats import (csr_from_scipy, partition_to,
                                          reduction_plan)
    from repro_torch.core.partition import (PartitionConfig,
                                            analyze_and_partition)
    from repro_torch.examples import quickstart as qs

    data = qs.prepare("pubmed", reorder_by=None, device=dev, seed=SEED)
    csr = data["csr"]
    rng = np.random.default_rng(SEED)
    a = sp.csr_matrix((rng.random(csr.data.shape[0]).astype(np.float32),
                       csr.indices, csr.indptr), shape=csr.shape)
    csr = csr_from_scipy(a)
    part, meta, _ = analyze_and_partition(csr, PartitionConfig(tile=qs.TILE))
    part = partition_to(part, dev)
    return dict(data, name="pubmed_asym", csr=csr, part=part, meta=meta,
                plan=reduction_plan(part, meta, device=dev))


def train_graph(torch, data, steps: int, learn_gate: bool) -> tuple:
    """Train one graph as the quickstart does and check it.

    Gates: the first step's weight gradients on the "cuda" backend within
    ``GRAD_TOL`` of the "torch" backend's and of ``csr_grads`` (a plain
    product over the CSR and its scipy transpose); "fused" gradients
    bitwise-equal to "ragged"; one launch of each path kernel per layer
    forward and per layer backward, read around each in every step
    (``counted_step``); the first ``RERUN_STEPS`` steps rerun from the
    same weights through ``make_hybrid_gcn_train_step`` give
    bitwise-equal weights, with as many launches; the trained weights
    served through ``Engine.register``/``infer`` within ``LOGIT_TOL`` of
    the training forward; a ``CheckpointManager`` round trip of the
    trained card tensors bitwise; with ``learn_gate``, the loss below
    0.7x its first value and test accuracy > 0.5 (the reference's
    tests/test_system.py and quickstart bars). ``steps`` 0 runs the
    gradient gates alone. Returns (problems, record, Aᵀ's adjoint, the
    backward launches read: the sum of the counter readings taken around
    each ``torch.autograd.grad`` of the gradient checks and the training
    steps).
    """
    import importlib
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.examples import quickstart as qs
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.steps import (hybrid_gcn_loss,
                                         make_hybrid_gcn_train_step)
    from repro_torch.tree import tree_leaves

    hs = importlib.import_module("repro_torch.core.hybrid_spmm")
    name, problems = data["name"], []
    ws0 = qs.init_weights(data, hidden=HIDDEN, seed=SEED)
    adj0 = hs.ADJOINTS.stats()
    _, g_ragged, fwd, bwd = train_grads(torch, data, ws0)
    adj1 = hs.ADJOINTS.stats()
    adj = hs.ADJOINTS.get(data["part"], data["meta"])
    _, g_plain, _, bwd_p = train_grads(torch, data, ws0, backend="torch")
    _, g_fused, fwd_f, bwd_f = train_grads(torch, data, ws0,
                                           ell_dispatch="fused")
    g_csr = csr_grads(torch, data, ws0)
    bwd_read = {k: bwd[k] + bwd_p[k] + bwd_f[k] for k in bwd}
    rec = dict(graph=name, n=data["meta"].n_rows, symmetric=adj.symmetric,
               adjoint_checks=adj1["checks"] - adj0["checks"],
               adjoint_builds=adj1["builds"] - adj0["builds"],
               adjoint_s=adj1["build_s"] - adj0["build_s"],
               grad_err_vs_torch=max(max_err(a, b)
                                     for a, b in zip(g_ragged, g_plain)),
               grads_close_torch=grads_close(g_ragged, g_plain),
               grad_err_vs_csr=max(max_err(a, b)
                                   for a, b in zip(g_ragged, g_csr)),
               grads_close_csr=grads_close(g_ragged, g_csr),
               fused_bitwise=all(torch.equal(a, b)
                                 for a, b in zip(g_fused, g_ragged)),
               fwd_launches=fwd, bwd_launches=bwd,
               fused_fwd_launches=fwd_f, fused_bwd_launches=bwd_f)
    if not rec["grads_close_torch"]:
        problems.append(f"train {name}: cuda gradients vs torch backend "
                        f"max_abs_err {rec['grad_err_vs_torch']}")
    if not rec["grads_close_csr"]:
        problems.append(f"train {name}: cuda gradients vs the plain CSR "
                        f"product max_abs_err {rec['grad_err_vs_csr']}")
    if not rec["fused_bitwise"]:
        problems.append(f"train {name}: fused gradients not bitwise-equal "
                        "to ragged")
    for got, want in ((fwd, _want_launches(data["meta"], "ragged")),
                      (bwd, _want_launches(adj.meta, "ragged")),
                      (fwd_f, _want_launches(data["meta"], "fused")),
                      (bwd_f, _want_launches(adj.meta, "fused"))):
        if got != want:
            problems.append(f"train {name}: launches {got}, want {want}")
    if rec["adjoint_checks"] != 1 or rec["adjoint_builds"] != (
            0 if adj.symmetric else 1):
        problems.append(f"train {name}: Aᵀ checked "
                        f"{rec['adjoint_checks']}x, built "
                        f"{rec['adjoint_builds']}x")
    if steps == 0:
        return problems, rec, adj, bwd_read

    opt = AdamW(lr=5e-3, weight_decay=1e-4)
    step = make_hybrid_gcn_train_step(data["part"], opt,
                                      **qs.forward_kw(data))
    batch = {"x": data["x"], "labels": data["y"], "mask": data["train"]}
    ws, state, losses, wall = ws0, opt.init(ws0), [], []
    off_steps = []
    for i in range(steps):
        t0 = time.perf_counter()
        ws, state, loss, fwd_i, bwd_i = counted_step(torch, opt, ws, state,
                                                     batch, data)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        for k in bwd_read:
            bwd_read[k] += bwd_i[k]
        if (fwd_i, bwd_i) != (fwd, bwd):
            off_steps.append((i, fwd_i, bwd_i))
        if i + 1 == RERUN_STEPS:
            ws_rerun_at = [w.clone() for w in ws]
    if off_steps:
        i, fwd_i, bwd_i = off_steps[0]
        problems.append(f"train {name}: {len(off_steps)} of {steps} steps "
                        f"off the first step's launches; step {i} forward "
                        f"{fwd_i}, backward {bwd_i}, want {fwd}, {bwd}")
    ws_b, st_b = ws0, opt.init(ws0)
    c0 = ops.launch_counts()
    for _ in range(RERUN_STEPS):
        ws_b, st_b, _ = step(ws_b, st_b, batch)
    rerun = _diff(c0, ops.launch_counts())
    want = {k: RERUN_STEPS * (fwd[k] + bwd[k]) for k in fwd}
    if rerun != want:
        problems.append(f"train {name}: {RERUN_STEPS} steps of the train "
                        f"step launched {rerun}, want {want}")
    rec["rerun_bitwise"] = all(torch.equal(a, b)
                               for a, b in zip(ws_b, ws_rerun_at))
    if not rec["rerun_bitwise"]:
        problems.append(f"train {name}: {RERUN_STEPS}-step rerun not "
                        "bitwise-equal")
    with torch.no_grad():
        logits = hs.gcn_forward(data["part"], data["x"], ws,
                                **qs.forward_kw(data))
    served = qs.serve_trained(data, ws)
    rec.update(steps=steps, first_loss=losses[0], final_loss=losses[-1],
               test_acc=qs.accuracy(data, ws, data["test"]),
               train_acc=qs.accuracy(data, ws, data["train"]),
               step_wall_ms=statistics.median(wall[1:]),
               first_step_wall_ms=wall[0],
               steps_off_first_launches=len(off_steps),
               backward_launches_read=bwd_read,
               served_err=max_err(served, logits),
               served_close=close(served, logits, **LOGIT_TOL))
    if not all(np.isfinite(losses)):
        problems.append(f"train {name}: non-finite loss")
    if learn_gate and not (losses[-1] < 0.7 * losses[0]
                           and rec["test_acc"] > 0.5):
        problems.append(f"train {name}: did not learn (loss {losses[0]} "
                        f"-> {losses[-1]}, test acc {rec['test_acc']})")
    if not rec["served_close"]:
        problems.append(f"train {name}: served logits vs training forward "
                        f"max_abs_err {rec['served_err']}")
    tree = {"params": {"w": ws}, "opt_state": state,
            "step": np.asarray(steps, np.int32)}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(steps, tree)
        mgr.wait()
        back, _ = mgr.restore_latest(tree)
    rec["checkpoint_bitwise"] = all(
        (torch.equal(a, b) and a.device == b.device)
        if isinstance(a, torch.Tensor) else np.array_equal(a, b)
        for a, b in zip(tree_leaves(tree), tree_leaves(back)))
    if not rec["checkpoint_bitwise"]:
        problems.append(f"train {name}: checkpoint round trip not bitwise")

    leaves = [w.detach().requires_grad_(True) for w in ws]

    def forward():
        return hybrid_gcn_loss(leaves, batch, part=data["part"],
                               **qs.forward_kw(data))

    prof = {k: profile_calls(torch, fn) for k, fn in (
        ("forward", forward),
        ("forward_backward",
         lambda: torch.autograd.grad(forward(), leaves)),
        ("step", lambda: step(ws, state, batch)))}
    f, fb, st = (prof[k]["device_ms_per_infer"]
                 for k in ("forward", "forward_backward", "step"))
    rec["device_ms"] = dict(forward=f, backward=fb - f, optimizer=st - fb,
                            step=st)
    rec["kernels_per_step"] = prof["step"]["kernels_per_infer"]
    rec["busy_share"] = prof["step"]["busy_share"]
    rec["top"] = prof["step"]["top"]
    rec["dtod_sources"] = copy_sources(torch, lambda: step(ws, state, batch))
    return problems, rec, adj, bwd_read


def backward_kernels(torch, data, adj) -> dict:
    """Each path kernel at the shape the backward gives it: layer 1's
    ``dB = Aᵀ·dY`` (width ``HIDDEN``) over Aᵀ's partition (A's own where
    A is symmetric), through the ``kernels.ops`` routes the executor
    takes, against the plain backend's engines on the same inputs
    (``max_abs_err``; gates: the ELL rows bitwise, as their forward is,
    the dense rows within ``KERNEL_TOL`` of the sum of |tile|·|B|) and
    timed (device ms, CUDA graphs). ``transposed``: the partition is
    Aᵀ's own (A not symmetric). Each record also has the forward
    cases' bound and library call on these inputs (``bsr_case``,
    ``ell_case``, ``fixed_ell_case``): ``bound_ms`` / ``bound_by`` (the
    folded function's bytes for ``bsr_spmm``, ``contract_cost`` for the
    ELL kernels) and ``library_ms`` (``torch.bmm`` + ``segment_sum``;
    ``torch.sparse.mm`` over Aᵀ's live rows, then ``index_add_``). The
    ELL records carry the launches of one call (``launches_per_call``,
    gated to 1: the fixed-K kernel takes every one of Aᵀ's K buckets,
    ``buckets``, in one launch). Reads no launch counter of a path's
    run."""
    import importlib

    from repro_torch.core.formats import b_tiles_of, pad_b_to_tiles
    from repro_torch.kernels import ops

    hs = importlib.import_module("repro_torch.core.hybrid_spmm")
    if adj.symmetric:
        part = type(data["part"])(*(type(c)(*(a[None] for a in c))
                                    for c in data["part"]))
        plan = data["plan"]
    else:
        part, plan = adj.on(data["part"].dense.tiles.device)
    meta = adj.meta
    gen = torch.Generator().manual_seed(SEED)
    dy = torch.randn((1, meta.n_cols, HIDDEN), generator=gen).to(
        data["device"])
    b = pad_b_to_tiles(dy, meta).contiguous()
    p = meta.n_padded_rows
    out = {}
    case = ([part.dense.tiles, part.dense.tile_col, part.ell.cols,
             part.ell.vals, part.ell.tile_col, part.ell.unit_k,
             part.ell.rows], b_tiles_of(b, meta).contiguous(), meta,
            plan.dense, plan.ell, plan.ell_bucket_k)

    def yardsticks(run):
        res = run(torch, case)
        return dict(bound_ms=res["bound"][0], bound_by=res["bound"][1],
                    library_ms=res["library_ms"])

    yd0 = hs.dense_tiles_matmul(part, b, meta, plan)
    if meta.n_dense_tiles:
        got = ops.dense_tiles_matmul(part, b, meta, plan)
        absolute = part._replace(dense=part.dense._replace(
            tiles=part.dense.tiles.abs()))
        scale = hs.dense_tiles_matmul(absolute, b.abs(), meta, plan)
        out["bsr_spmm"] = dict(
            graph=data["name"], transposed=not adj.symmetric, F=HIDDEN,
            max_abs_err=max_err(got, yd0),
            ok=bool(((got - yd0).abs() <= KERNEL_TOL["atol"]
                     + KERNEL_TOL["rtol"] * scale).all()),
            ms=device_ms(torch, lambda: ops.dense_tiles_matmul(
                part, b, meta, plan)), **yardsticks(bsr_case))
    for kname, dispatch, run in (("ragged_ell_spmm", "ragged", ell_case),
                                 ("ell_spmm", "fused", fixed_ell_case)):
        if not meta.ell_segments:
            continue
        want = yd0 + hs.ell_matmul(part, b, meta, plan, dispatch=dispatch)
        c0 = ops.launch_counts()[kname]
        got = ops.ell_matmul(part, b, meta, plan, yd0.clone(),
                             dispatch=dispatch)
        launches = ops.launch_counts()[kname] - c0
        buf = yd0.clone()
        out[kname] = dict(
            graph=data["name"], transposed=not adj.symmetric, F=HIDDEN,
            dispatch=dispatch, launches_per_call=launches,
            buckets=len(meta.ell_segments),
            max_abs_err=max_err(got, want),
            ok=torch.equal(got, want) and launches == 1, rows=p,
            ms=device_ms(torch, lambda: ops.ell_matmul(
                part, b, meta, plan, buf, dispatch=dispatch)),
            **yardsticks(run))
    return out


def train_phase(torch, smi: str, dev="cuda") -> tuple:
    """The training path: cora reordered by labels and pubmed in its
    natural order, each trained as ``repro_torch.examples.quickstart``
    does (``train_graph``), and the first step's gradients of pubmed with
    random edge values (not symmetric). The launch counters are set to 0
    just before and read just after.

    Returns (problems, record, launches of the run, per-kernel lists of
    backward records, one per graph whose Aᵀ has the kernel's work,
    backward launches per kernel: the sum of the counter readings
    taken around each backward of the gradient checks and the training
    steps)."""
    import importlib

    from repro_torch.examples import quickstart as qs
    from repro_torch.kernels import ops

    hs = importlib.import_module("repro_torch.core.hybrid_spmm")
    problems, graphs = [], []
    t_start = time.perf_counter()
    datas = [qs.prepare(name, reorder_by=by, device=dev, seed=SEED)
             for name, by, *_ in TRAIN_GRAPHS]
    datas[0]["name"] = "cora@labels"
    datas.append(asymmetric_pubmed(torch, dev))
    prep_s = time.perf_counter() - t_start
    ops.reset_launch_counts()
    adj0 = hs.ADJOINTS.stats()
    bwd_launches = dict.fromkeys(ops.launch_counts(), 0)
    adjoints = []
    for data, (*_, steps, learn) in zip(datas, TRAIN_GRAPHS + (
            (None, None, 0, False),)):
        p, rec, adjoint, read = train_graph(torch, data, steps, learn)
        problems += p
        graphs.append(rec)
        adjoints.append(adjoint)
        for k in bwd_launches:
            bwd_launches[k] += read[k]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    adj = _diff(adj0, hs.ADJOINTS.stats())
    if adj["builds"] > 1:
        problems.append(f"train: Aᵀ built {adj['builds']}x over "
                        f"{len(datas)} graphs (once for the asymmetric one)")
    for k in ("ragged_ell_spmm", "bsr_spmm", "ell_spmm"):
        if counts[k] == 0:
            problems.append(f"{k} never launched on the training path")
    kernels = {}
    for data, adjoint in zip(datas, adjoints):
        for k, v in backward_kernels(torch, data, adjoint).items():
            kernels.setdefault(k, []).append(v)
    for k, cases in kernels.items():
        for v in cases:
            if not v["ok"]:
                problems.append(f"{k} in the backward ({v['graph']}, F="
                                f"{v['F']}) disagrees with its plain "
                                f"version ({v['max_abs_err']})")
    record = dict(gpu=smi, prepare_s=prep_s, graphs=graphs,
                  adjoint=adj, launches=counts,
                  backward_launches=bwd_launches,
                  phase_s=time.perf_counter() - t_start)
    return problems, record, counts, kernels, bwd_launches


# --------------------------------------------------- language models, FM ----
# qwen3-0.6b at its full CONFIG (28 layers, d 1024, 16/8 heads, d_ff 3072,
# vocab 151936): train_4k's length with the global batch cut from 256 to
# 2 for one card; prefill_32k cut to 8192 tokens at batch 1; decode_32k
# at batch 8 (cut from 128) against a 32768-slot cache.
QWEN = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, LM_RERUN_STEPS = 2, 4096, 8, 3
PREFILL_SEQ, DECODE_TOKENS = 8192, 32
DECODE_BATCH, DECODE_SLOTS, DECODE_TIMED = 8, 32768, 8
# f32 parity on the card: prefill PARITY_SEQ - 1 tokens then decode one
# against the forward's last position, within the reference's own bound
# (tests/test_models_lm.py: 5e-5) scaled by max(1, max |logits|); and the
# card's forward against the port's plain CPU forward of the same weights
# at 1 x CPU_SEQ tokens, |card - cpu| <= 1e-4 * (max |cpu| + |cpu|)
PARITY_BATCH, PARITY_SEQ, CPU_SEQ = 2, 1024, 128
DECODE_BOUND, CPU_TOL = 5e-5, 1e-4
# mixtral-8x7b at full width, depth cut from 32 to 2 layers: prefill past
# the 4096 window (so prefill's ring roll runs), decode 4 tokens; at f32
# each decode equals the windowed forward within the bound of
# test_swa_ring_buffer_long_decode
MIXTRAL, MIXTRAL_LAYERS = "mixtral-8x7b", 2
MIXTRAL_PROMPT, MIXTRAL_DECODE, MIXTRAL_BOUND = 4159, 4, 1e-4
# fm at its full CONFIG (39 fields, 33.8 M rows x 10): train_batch,
# serve_p99, retrieval_cand with n_user = 20 (the reference's launch spec)
FM_TRAIN_BATCH, FM_TRAIN_STEPS, FM_SERVE_BATCH = 65536, 3, 512
FM_CANDIDATES, FM_USER_FIELDS = 1_000_000, 20
FM_TOL = dict(rtol=1e-4, atol=1e-5)
# H100 SXM published dense BF16 tensor-core peak (NVIDIA data sheet)
BF16_PEAK_FLOPS = 989e12


def lm_flops(cfg, b: int, s: int, *, ctx: int = 0, logits: int = 0) -> float:
    """Model FLOPs of one forward: 2 per weight per token for every
    product (the k routed experts of a MoE token, the router), the head
    on ``logits`` tokens per sequence (all ``s`` when 0), and 4·d_head per
    attended (query, key) pair per head: causal, within the window, the
    keys at ``ctx`` earlier positions plus the new ones."""
    d, dh, f = cfg.d_model, cfg.d_head, cfg.d_ff
    attn = d * cfg.n_heads * dh * 2 + d * cfg.n_kv_heads * dh * 2
    ffn = 3 * d * f * (cfg.top_k if cfg.moe else 1) + (
        d * cfg.n_experts if cfg.moe else 0)
    body = 2.0 * cfg.n_layers * (attn + ffn) * b * s
    head = 2.0 * d * cfg.vocab * b * (logits or s)
    w = cfg.sliding_window or ctx + s
    pairs = sum(min(ctx + i + 1, w) for i in range(s))
    return body + head + 4.0 * dh * cfg.n_heads * cfg.n_layers * b * pairs


def timed_call(torch, fn) -> tuple:
    """(result, host ms) of one call ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rates(ms: float, flops: float, items: float) -> dict:
    return dict(wall_ms=ms, per_s=items / ms * 1e3,
                model_tflops=flops / 1e12,
                bf16_peak_share=flops / (ms * 1e-3) / BF16_PEAK_FLOPS)


# device kernels by what they compute, matched on the kernel's name (its
# functor for PyTorch's elementwise and reduce kernels); first match wins
KERNEL_KINDS = (
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
    ("memcpy", ("Memcpy", "Memset")),
    ("copy/cast", ("copy_kernel", "CatArray")),
    ("where", ("where_kernel",)),
    ("exp/log", ("exp_kernel", "log_kernel", "log1p")),
    ("mul", ("MulFunctor",)),
    ("add/sub", ("AddFunctor", "CUDAFunctor_add", "sub_kernel")),
    ("div", ("DivFunctor", "div_true")),
    ("max", ("maximum", "MaxOps", "max_kernel", "clamp")),
    ("compare/bool", ("compare", "bitwise", "CompareFunctor", "logical")),
    ("segment/gather", ("segment_reduce", "gather", "index", "scatter")),
    ("sum/reduce", ("reduce_kernel",)),
    ("fill", ("FillFunctor", "fill_kernel")),
    ("pow/sqrt/trig", ("rsqrt", "sqrt", "cos_kernel", "sin_kernel", "pow")),
    ("silu", ("silu",)),
)


def kernel_kind(name: str) -> str:
    for kind, marks in KERNEL_KINDS:
        if any(m in name for m in marks):
            return kind
    return "other"


def device_items(torch, fn) -> dict:
    """Device ms of one call, its kernels and busy share, its five
    largest device items (name and kind) and its device ms by kind
    (``profile_calls`` over the device alone)."""
    prof = profile_calls(torch, fn, calls=1, cpu=False, detail=True)
    per = prof["per_kernel"]
    by_kind = {}
    for name, ms in per.items():
        kind = kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return dict(device_ms=prof["device_ms_per_infer"],
                kernels=prof["kernels_per_infer"],
                busy_share=prof["busy_share"],
                top5=[[kernel_kind(k), k[:160], ms] for k, ms in top],
                by_kind=dict(sorted(by_kind.items(), key=lambda kv: -kv[1])))


def peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def _batch(torch, b) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def _bitwise(torch, a, b) -> bool:
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def qwen_train(torch, cfg, params) -> tuple:
    """8 AdamW steps (warmup-cosine, bf16 compute, remat) at 2 x 4096
    tokens; gates: losses finite and falling, no all-zero gradient (read
    through ``compress`` at the first step), a 3-step rerun from the
    same state bitwise. The last steps run under the profiler."""
    from repro_torch.data import TokenStream
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    from repro_torch.train.steps import make_lm_train_step
    from repro_torch.tree import flatten_with_path

    problems, nonzero = [], []

    def watch(grads):
        if not nonzero:
            nonzero.extend((k, bool((g != 0).any()))
                           for k, g in flatten_with_path(grads))
        return grads

    opt = AdamW(lr=warmup_cosine(1e-3, 2, TRAIN_STEPS), weight_decay=0.01)
    step = make_lm_train_step(cfg, opt, remat=True, compress=watch)
    stream = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    run = dict(p=params, s=opt.init(params), i=0, losses=[], ms=[])

    def one():
        t0 = time.perf_counter()
        run["p"], run["s"], m = step(run["p"], run["s"],
                                     _batch(torch, stream.batch_at(run["i"])))
        run["losses"].append(float(m["loss"]))
        run["ms"].append((time.perf_counter() - t0) * 1e3)
        run["i"] += 1
        if run["i"] == LM_RERUN_STEPS:
            run["at_rerun"] = (run["p"], run["s"], list(run["losses"]))

    for _ in range(TRAIN_STEPS - 3):
        one()
    prof = device_items(torch, one)          # three more steps, one traced
    losses, train_ms = run["losses"], run["ms"]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        problems.append(f"lm train: losses {losses}")
    elif not losses[-1] < losses[0]:
        problems.append(f"lm train: loss did not fall {losses}")
    zero = [k for k, ok in nonzero if not ok]
    if not nonzero or zero:
        problems.append(f"lm train: all-zero gradients {zero}")
    peak = peak_gib(torch)

    p3, s3, l3 = run.pop("at_rerun")
    run.update(p=params, s=opt.init(params), i=0, losses=[], ms=[])
    for _ in range(LM_RERUN_STEPS):
        one()
    rerun_bitwise = (run["losses"] == l3 and _bitwise(torch, run["p"], p3)
                     and _bitwise(torch, run["s"], s3))
    if not rerun_bitwise:
        problems.append(f"lm train: {LM_RERUN_STEPS}-step rerun not "
                        f"bitwise ({run['losses']} vs {l3})")
    # the steps outside the profiler, the first (allocations) left out
    ms = statistics.median(train_ms[1:TRAIN_STEPS - 3])
    flops = 3 * lm_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    record = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                  losses=losses, step_ms=train_ms,
                  rerun_bitwise=rerun_bitwise, max_memory_gib=peak,
                  **rates(ms, flops, TRAIN_BATCH * TRAIN_SEQ), **prof)
    return problems, record


def qwen_breakdown(torch, cfg, params) -> dict:
    """Host ms (each the second of two calls ending in a synchronize) of
    the train step's parts at its shape: the loss's forward alone, its
    value and gradient (forward, remat recompute, backward), the AdamW
    update; and, inside those, one layer's attention forward and
    forward + backward, and the chunked cross-entropy forward + backward
    over the head."""
    from repro_torch.data import TokenStream
    from repro_torch.models.attention import chunked_attention
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.steps import (chunked_cross_entropy, lm_loss,
                                         value_and_grad)

    def twice(fn):
        fn()
        return timed_call(torch, fn)

    batch = _batch(torch, TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=SEED).batch_at(0))
    out = {}
    with torch.no_grad():
        _, out["forward_ms"] = twice(lambda: lm_loss(params, batch, cfg))
    (_, grads), out["value_and_grad_ms"] = twice(
        lambda: value_and_grad(lambda p, b: lm_loss(p, b, cfg), params,
                               batch))
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    state = opt.init(params)
    _, out["adamw_ms"] = twice(lambda: opt.update(grads, state, params))
    del grads, state
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, s, dh = TRAIN_BATCH, TRAIN_SEQ, cfg.d_head
    q, k, v = (torch.randn((b, s, h, dh), generator=gen, device=dev)
               .to(torch.bfloat16).requires_grad_(True)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    pos = torch.arange(s, device=dev)

    def attn():
        return chunked_attention(q, k, v, q_pos=pos, kv_pos=pos)

    with torch.no_grad():
        _, out["attention_layer_forward_ms"] = twice(attn)
    _, out["attention_layer_forward_backward_ms"] = twice(
        lambda: torch.autograd.grad(attn().float().sum(), (q, k, v)))
    h = torch.randn((b, s, cfg.d_model), generator=gen, device=dev,
                    requires_grad=True)
    head = params["lm_head"].detach().requires_grad_(True)
    _, out["xent_forward_backward_ms"] = twice(
        lambda: torch.autograd.grad(chunked_cross_entropy(
            h, head, batch["labels"]), (h, head)))
    return out


def qwen_serve(torch, cfg, params) -> tuple:
    """bf16 prefill of 8192 tokens at batch 1 and 32 decode steps on its
    cache; then decode at batch 8 against a 32768-slot cache."""
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as tfm
    from repro_torch.train.steps import (make_lm_decode_step,
                                         make_lm_prefill_step)

    problems = []
    toks = torch.from_numpy(TokenStream(
        cfg.vocab, 1, PREFILL_SEQ + DECODE_TOKENS, seed=SEED).batch_at(0)[
            "tokens"]).cuda()
    # room for the decode steps and the three of the profile
    prefill = make_lm_prefill_step(cfg, max_len=PREFILL_SEQ + DECODE_TOKENS
                                   + 3)
    decode = make_lm_decode_step(cfg)
    prompt = toks[:, :PREFILL_SEQ]
    prefill(params, prompt)
    torch.cuda.reset_peak_memory_stats()
    (logits, cache), pre_ms = timed_call(torch,
                                         lambda: prefill(params, prompt))
    pre_peak = peak_gib(torch)
    pre_prof = device_items(torch, lambda: prefill(params, prompt))
    dec_ms, outs = [], [logits]
    for i in range(DECODE_TOKENS):
        tok = toks[:, PREFILL_SEQ + i:PREFILL_SEQ + i + 1]
        (lg, cache), ms = timed_call(torch, lambda: decode(params, cache,
                                                           tok))
        dec_ms.append(ms)
        outs.append(lg)
    if not all(bool(torch.isfinite(x).all()) for x in outs):
        problems.append("lm prefill/decode: non-finite logits")
    if int(cache["index"]) != PREFILL_SEQ + DECODE_TOKENS:
        problems.append(f"lm decode: cache index {int(cache['index'])}")
    dec_prof = device_items(torch, lambda: decode(params, cache, tok))
    del cache
    torch.cuda.empty_cache()

    big = tfm.init_cache(cfg, DECODE_BATCH, DECODE_SLOTS)
    torch.cuda.reset_peak_memory_stats()
    stream = TokenStream(cfg.vocab, DECODE_BATCH, DECODE_TIMED + 4,
                         seed=SEED).batch_at(0)["tokens"]
    big_ms = []
    for i in range(DECODE_TIMED + 1):
        tok = torch.from_numpy(stream[:, i:i + 1]).cuda()
        (lg, big), ms = timed_call(torch, lambda: decode(params, big, tok))
        big_ms.append(ms)
    tok = torch.from_numpy(stream[:, -1:]).cuda()
    big_prof = device_items(torch, lambda: decode(params, big, tok))
    if not bool(torch.isfinite(lg).all()):
        problems.append("lm decode at 32k slots: non-finite logits")
    big_peak = peak_gib(torch)
    del big
    torch.cuda.empty_cache()
    dec = statistics.median(dec_ms[1:])
    big_dec = statistics.median(big_ms[1:])
    record = dict(
        prefill=dict(batch=1, seq=PREFILL_SEQ, max_memory_gib=pre_peak,
                     **rates(pre_ms, lm_flops(cfg, 1, PREFILL_SEQ, logits=1),
                             PREFILL_SEQ), **pre_prof),
        decode=dict(batch=1, tokens=DECODE_TOKENS, ms_per_token=dec,
                    first_ms=dec_ms[0],
                    **rates(dec, lm_flops(cfg, 1, 1, ctx=PREFILL_SEQ), 1),
                    **dec_prof),
        decode_32k=dict(batch=DECODE_BATCH, slots=DECODE_SLOTS,
                        ms_per_token=big_dec, first_ms=big_ms[0],
                        max_memory_gib=big_peak,
                        # the reference attends over every slot
                        **rates(big_dec, lm_flops(cfg, DECODE_BATCH, 1,
                                                  ctx=DECODE_SLOTS - 1),
                                DECODE_BATCH), **big_prof))
    return problems, record


def qwen_parity(torch, cfg, params) -> tuple:
    """f32 on the card: decode after an (S-1)-token prefill equals the
    forward's last position; the card's forward equals the port's plain
    CPU forward of the same weights."""
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map

    problems = []
    toks = torch.from_numpy(TokenStream(cfg.vocab, PARITY_BATCH, PARITY_SEQ,
                                        seed=SEED).batch_at(0)[
                                            "tokens"]).cuda()
    with torch.no_grad():
        h = tfm.forward(params, toks, cfg, remat=False, compute_dtype=None)
        want = tfm.logits_fn(params, h[:, -1], cfg)
        _, cache = tfm.prefill(params, toks[:, :-1], cfg,
                               max_len=PARITY_SEQ, cache_dtype=torch.float32,
                               compute_dtype=None)
        got, _ = tfm.decode_step(params, cache, toks[:, -1:], cfg,
                                 compute_dtype=None)
    del cache, h
    dec_err = max_err(got[:, 0], want)
    dec_bound = DECODE_BOUND * max(1.0, float(want.abs().max()))
    if not dec_err < dec_bound:
        problems.append(f"lm f32 decode vs forward: {dec_err} >= "
                        f"{dec_bound}")
    short = toks[:1, :CPU_SEQ]
    cpu_params = tree_map(lambda p: p.cpu(), params)
    with torch.no_grad():
        card = tfm.logits_fn(params, tfm.forward(
            params, short, cfg, remat=False, compute_dtype=None), cfg).cpu()
        t0 = time.perf_counter()
        plain = tfm.logits_fn(cpu_params, tfm.forward(
            cpu_params, short.cpu(), cfg, remat=False, compute_dtype=None),
            cfg)
        cpu_s = time.perf_counter() - t0
    del cpu_params
    cpu_err = max_err(card, plain)
    bound = CPU_TOL * (float(plain.abs().max()) + plain.abs())
    if not bool(((card - plain).abs() <= bound).all()):
        problems.append(f"lm f32 card vs CPU forward: max_abs_err {cpu_err}")
    record = dict(decode_vs_forward=dict(
        batch=PARITY_BATCH, seq=PARITY_SEQ, max_abs_err=dec_err,
        bound=dec_bound, max_abs_logit=float(want.abs().max())),
        card_vs_cpu=dict(batch=1, seq=CPU_SEQ, max_abs_err=cpu_err,
                         max_abs_logit=float(plain.abs().max()),
                         cpu_forward_s=cpu_s))
    return problems, record


def mixtral_phase(torch) -> tuple:
    """mixtral-8x7b, full width, 2 layers: at f32 with a capacity factor
    of E / k (every expert can take every token: nothing drops), prefill
    4159 tokens at batch 1 (past the 4096 window: the ring roll runs)
    and decode 4; each decode's logits equal the windowed forward's at
    its position. Then bf16 at the config's capacity factor: prefill
    and decode of the same prompt, timed."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as tfm
    from repro_torch.train.steps import (make_lm_decode_step,
                                         make_lm_prefill_step)

    problems = []
    full = get_arch(MIXTRAL).config
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    exact = dataclasses.replace(
        cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = tfm.init_params(cfg, gen, device="cuda")
    n = MIXTRAL_PROMPT + MIXTRAL_DECODE
    toks = torch.from_numpy(TokenStream(cfg.vocab, 1, n, seed=SEED).batch_at(
        0)["tokens"]).cuda()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        h = tfm.forward(params, toks, exact, remat=False, compute_dtype=None)
        want = tfm.logits_fn(params, h[:, MIXTRAL_PROMPT:], exact)
        del h
        _, cache = tfm.prefill(params, toks[:, :MIXTRAL_PROMPT], exact,
                               max_len=n, cache_dtype=torch.float32,
                               compute_dtype=None)
    t_buf = cache["k"].shape[2]
    errs = []
    for i in range(MIXTRAL_DECODE):
        at = MIXTRAL_PROMPT + i
        lg, cache = tfm.decode_step(params, cache, toks[:, at:at + 1], exact,
                                    compute_dtype=None)
        errs.append(max_err(lg[:, 0], want[:, i]))
    f32_peak = peak_gib(torch)
    del cache
    if t_buf != cfg.sliding_window or (MIXTRAL_PROMPT - t_buf) % t_buf == 0:
        problems.append(f"mixtral: ring of {t_buf} slots, no roll")
    if not max(errs) < MIXTRAL_BOUND:
        problems.append(f"mixtral f32 decode vs windowed forward: {errs}")

    prefill = make_lm_prefill_step(cfg, max_len=n)
    decode = make_lm_decode_step(cfg)
    prompt = toks[:, :MIXTRAL_PROMPT]
    prefill(params, prompt)
    torch.cuda.reset_peak_memory_stats()
    (logits, cache), pre_ms = timed_call(torch,
                                         lambda: prefill(params, prompt))
    pre_prof = device_items(torch, lambda: prefill(params, prompt))
    dec_ms = []
    for i in range(MIXTRAL_DECODE):
        at = MIXTRAL_PROMPT + i
        (lg, cache), ms = timed_call(
            torch, lambda: decode(params, cache, toks[:, at:at + 1]))
        dec_ms.append(ms)
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(lg).all())):
        problems.append("mixtral bf16: non-finite logits")
    tok = toks[:, -1:]
    dec_prof = device_items(torch, lambda: decode(params, cache, tok))
    bf16_peak = peak_gib(torch)
    del params, cache
    torch.cuda.empty_cache()
    dec = statistics.median(dec_ms[1:])
    record = dict(
        arch=MIXTRAL, layers=MIXTRAL_LAYERS,
        params_b=cfg.n_params_dense / 1e9,
        f32=dict(prompt=MIXTRAL_PROMPT, ring_slots=t_buf,
                 roll=(MIXTRAL_PROMPT - t_buf) % t_buf,
                 capacity_factor=exact.capacity_factor,
                 decode_vs_forward=errs, bound=MIXTRAL_BOUND,
                 max_memory_gib=f32_peak),
        bf16=dict(capacity_factor=cfg.capacity_factor,
                  max_memory_gib=bf16_peak,
                  prefill=dict(**rates(pre_ms, lm_flops(
                      cfg, 1, MIXTRAL_PROMPT, logits=1), MIXTRAL_PROMPT),
                      **pre_prof),
                  decode=dict(ms_per_token=dec, first_ms=dec_ms[0],
                              **rates(dec, lm_flops(
                                  cfg, 1, 1, ctx=MIXTRAL_PROMPT), 1),
                              **dec_prof)),
        reduced=[f"n_layers {full.n_layers} -> {MIXTRAL_LAYERS}",
                 f"f32 check: capacity_factor {full.capacity_factor} -> "
                 f"{exact.capacity_factor} (no drops)",
                 f"prefill 32768 x 32 -> {MIXTRAL_PROMPT} x 1 (past the "
                 f"{full.sliding_window} window)"])
    return problems, record


def lm_phase(torch, smi: str) -> tuple:
    """The language-model path: qwen3-0.6b at its full config (train,
    f32 parity, prefill and decode), then mixtral at full width."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import count_params

    t0 = time.perf_counter()
    cfg = get_arch(QWEN).config
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = tfm.init_params(cfg, gen, device="cuda")
    problems, train = qwen_train(torch, cfg, params)
    torch.cuda.empty_cache()
    train["breakdown"] = qwen_breakdown(torch, cfg, params)
    torch.cuda.empty_cache()
    p, parity = qwen_parity(torch, cfg, params)
    problems += p
    p, serve = qwen_serve(torch, cfg, params)
    problems += p
    n_params = count_params(params)
    del params
    torch.cuda.empty_cache()
    p, mixtral = mixtral_phase(torch)
    problems += p
    record = dict(
        gpu=smi, arch=QWEN, params_m=n_params / 1e6, train=train,
        parity=parity, **serve, mixtral=mixtral,
        peak_note="share of the H100 SXM dense BF16 peak, 989 TFLOP/s",
        attention_products="torch.bmm(..., out_dtype=torch.float32)",
        reduced=[f"train_4k global batch 256 -> {TRAIN_BATCH}",
                 f"prefill_32k 32768 x 32 -> {PREFILL_SEQ} x 1",
                 f"decode_32k batch 128 -> {DECODE_BATCH}"],
        phase_s=time.perf_counter() - t0)
    return problems, record


def fm_phase(torch, smi: str) -> tuple:
    """fm at its full config: 3 AdamW steps at batch 65536, serve at 512
    (scores against the pairwise oracle), retrieval of one user's 20
    fields against 1,000,000 candidates (against direct scores of the
    first 512)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import ClickStream
    from repro_torch.models import fm as fm_m
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.steps import (make_fm_retrieval_step,
                                         make_fm_serve_step,
                                         make_fm_train_step)

    t0 = time.perf_counter()
    problems = []
    cfg = get_arch("fm").config
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = fm_m.fm_init(cfg, gen, device="cuda")
    opt = AdamW(lr=1e-3)
    step = make_fm_train_step(cfg, opt)
    stream = ClickStream(cfg.vocab_sizes, FM_TRAIN_BATCH, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    run = dict(p=params, s=opt.init(params), i=0, losses=[], ms=[])

    def one():
        t1 = time.perf_counter()
        run["p"], run["s"], m = step(run["p"], run["s"],
                                     _batch(torch, stream.batch_at(run["i"])))
        run["losses"].append(float(m["loss"]))
        run["ms"].append((time.perf_counter() - t1) * 1e3)
        run["i"] += 1

    for _ in range(FM_TRAIN_STEPS):
        one()
    losses, train_ms = list(run["losses"]), list(run["ms"])
    prof = device_items(torch, one)       # three more steps, one traced
    if not all(np.isfinite(run["losses"])):
        problems.append(f"fm train: losses {run['losses']}")
    train_peak = peak_gib(torch)
    params = run.pop("p")
    del run
    f = cfg.n_sparse
    flops = 2.0 * FM_TRAIN_BATCH * f * cfg.embed_dim * 3 * 3

    serve = make_fm_serve_step(cfg)
    sb = ClickStream(cfg.vocab_sizes, FM_SERVE_BATCH, seed=SEED).batch_at(0)
    idx = torch.from_numpy(sb["idx"]).cuda()
    with torch.no_grad():
        ref = fm_m.fm_score_ref(params, idx, cfg)
    got = serve(params, {"idx": idx})
    serve_err = max_err(got, ref)
    if not close(got, ref, **FM_TOL):
        problems.append(f"fm serve vs pairwise oracle: {serve_err}")
    serve_ms = wall_ms(torch, lambda: serve(params, {"idx": idx}))
    serve_prof = device_items(torch, lambda: serve(params, {"idx": idx}))

    cand_b = ClickStream(cfg.vocab_sizes, FM_CANDIDATES,
                         seed=SEED).batch_at(0)["idx"]
    raw = cand_b.copy()
    raw[:, :FM_USER_FIELDS] = raw[0, :FM_USER_FIELDS]     # one user
    flat = raw + fm_m.field_offsets(cfg)[None, :]
    user = torch.from_numpy(flat[0, :FM_USER_FIELDS]).cuda()
    cand = torch.from_numpy(flat[:, FM_USER_FIELDS:]).cuda()
    retrieve = make_fm_retrieval_step(cfg, FM_USER_FIELDS)
    scores = retrieve(params, user, cand)
    direct = serve(params, {"idx": torch.from_numpy(raw[:512]).cuda()})
    ret_err = max_err(scores[:512], direct)
    if tuple(scores.shape) != (FM_CANDIDATES,) or not bool(
            torch.isfinite(scores).all()):
        problems.append(f"fm retrieval: shape {tuple(scores.shape)} or "
                        "non-finite scores")
    if not close(scores[:512], direct, **FM_TOL):
        problems.append(f"fm retrieval vs direct scores: {ret_err}")
    torch.cuda.reset_peak_memory_stats()
    ret_ms = wall_ms(torch, lambda: retrieve(params, user, cand))
    ret_prof = device_items(torch, lambda: retrieve(params, user, cand))
    ret_peak = peak_gib(torch)
    n_cf = f - FM_USER_FIELDS
    del params, scores
    torch.cuda.empty_cache()
    record = dict(
        gpu=smi, rows=int(sum(cfg.vocab_sizes)), fields=f,
        embed_dim=cfg.embed_dim,
        train=dict(batch=FM_TRAIN_BATCH, steps=FM_TRAIN_STEPS, losses=losses,
                   step_ms=train_ms, max_memory_gib=train_peak,
                   **rates(statistics.median(train_ms[1:]), flops,
                           FM_TRAIN_BATCH), **prof),
        serve=dict(batch=FM_SERVE_BATCH, max_abs_err_vs_oracle=serve_err,
                   **rates(serve_ms, 2.0 * FM_SERVE_BATCH * f
                           * cfg.embed_dim * 3, FM_SERVE_BATCH),
                   **serve_prof),
        retrieval=dict(candidates=FM_CANDIDATES, user_fields=FM_USER_FIELDS,
                       max_abs_err_vs_direct=ret_err,
                       max_memory_gib=ret_peak,
                       **rates(ret_ms, 2.0 * FM_CANDIDATES * n_cf
                               * cfg.embed_dim * 3, FM_CANDIDATES),
                       **ret_prof),
        reduced=[], phase_s=time.perf_counter() - t0)
    return problems, record


# ------------------------------------------------------ geometric phase ----
# the `molecule` shape cell (configs/base.py: 30 atoms, 64 edges a
# molecule) at 128 molecules; a cutoff of 1.55 gives 64.5 edges a molecule
# (the reference's default of 3.0 gives five times the cell's)
GEO_MOLS, GEO_ATOMS, GEO_CUTOFF = 128, 30, 1.55
GEO_STEPS = 20
GEO_RERUN = 3
# AdamW's learning rate: DimeNet's seeded energies are in the hundreds
# against N(0, 1) targets, and at 1e-3 its first steps overshoot by
# orders of magnitude; at 1e-4 its loss falls steadily
GEO_LR = {"dimenet": 1e-4, "nequip": 1e-3}
# f32 energies on the card vs the port's CPU forward: |card - cpu| <=
# 1e-4 * (max|cpu| + |cpu|) (the LM phase's rule)
GEO_CPU_RTOL = 1e-4
# energy invariance under a rotation and shift: the reference's own
# tolerances (tests/test_models_gnn.py, TestNequIP / TestDimeNet)
INVARIANCE_TOL = {"nequip": dict(rtol=1e-4, atol=1e-7),
                  "dimenet": dict(rtol=1e-4, atol=1e-6)}


def molecule_batches(torch) -> tuple:
    """(host numpy batch, CPU tensors, card tensors) of the molecule
    cell with seeded target energies; the card's batch is placed once,
    so the take and segment plans of its index tensors are built once."""
    from repro_torch.data.graphs import random_molecules

    mols = random_molecules(GEO_MOLS, GEO_ATOMS, cutoff=GEO_CUTOFF,
                            seed=SEED)
    host = {k: v for k, v in mols.items() if k != "n_mols"}
    host["energy"] = np.random.default_rng(SEED).standard_normal(
        GEO_MOLS).astype(np.float32)
    cpu = {k: torch.from_numpy(v) for k, v in host.items()}
    return host, cpu, {k: v.cuda() for k, v in cpu.items()}


def zero_leaves(torch, grads) -> list:
    """Keypaths of the gradient leaves that are all zero."""
    from repro_torch.tree import flatten_with_path
    return [path for path, g in flatten_with_path(grads)
            if not bool(torch.any(g != 0))]


def rotated(torch, host, batch, seed) -> dict:
    """``batch`` with its positions rotated (a seeded rotation) and
    shifted, on the card; the index tensors are the same objects."""
    from scipy.stats import special_ortho_group

    rot = special_ortho_group.rvs(3, random_state=seed)
    shift = np.random.default_rng(seed).standard_normal(3) * 4
    pos = (host["pos"].astype(np.float64) @ rot.T + shift).astype(
        np.float32)
    return dict(batch, pos=torch.from_numpy(pos).cuda())


def geometric_model(torch, arch, host, cpu_batch, batch) -> tuple:
    """One geometric GNN at its full config on the molecule cell: serve
    (card vs CPU, invariance, times), the first step's gradients (card
    vs CPU zero leaves, remat bitwise), GEO_STEPS AdamW steps (finite
    and falling, a bitwise rerun of the first GEO_RERUN, timed and
    profiled), one step through the EF-compression hook."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.collectives import (
        compress_with_error_feedback, ef_init)
    from repro_torch.models import dimenet, nequip
    from repro_torch.models.common import count_params
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamW
    from repro_torch.tree import tree_leaves, tree_map

    problems = []
    cfg = get_arch(arch).config
    init = dimenet.dimenet_init if arch == "dimenet" else nequip.nequip_init
    loss_fn = (steps.energy_loss_dimenet if arch == "dimenet"
               else steps.energy_loss_nequip)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init(cfg, gen, device="cuda")
    cpu_params = tree_map(lambda p: p.cpu(), params)
    serve = steps.make_gnn_serve_step(cfg, n_mols=GEO_MOLS)

    e = serve(params, batch)
    e_cpu = serve(cpu_params, cpu_batch)
    err = max_err(e.cpu(), e_cpu)
    bound = GEO_CPU_RTOL * (e_cpu.abs().max() + e_cpu.abs())
    if tuple(e.shape) != (GEO_MOLS,) or not bool(torch.isfinite(e).all()):
        problems.append(f"{arch} serve: shape {tuple(e.shape)} or "
                        "non-finite energies")
    if not bool(((e.cpu() - e_cpu).abs() <= bound).all()):
        problems.append(f"{arch} card vs CPU energies: {err}")
    e_rot = serve(params, rotated(torch, host, batch, SEED))
    rot_err = max_err(e_rot, e)
    if not close(e_rot, e, **INVARIANCE_TOL[arch]):
        problems.append(f"{arch} energy under rotation and shift: {rot_err}")
    serve_ms = wall_ms(torch, lambda: serve(params, batch))
    serve_prof = device_items(torch, lambda: serve(params, batch))

    def vg(p, b, **kw):
        return steps.value_and_grad(
            lambda q, c: loss_fn(q, c, cfg, **kw), p, b)

    loss0, g0 = vg(params, batch)
    loss0_cpu, g0_cpu = vg(cpu_params, cpu_batch)
    zeros, zeros_cpu = zero_leaves(torch, g0), zero_leaves(torch, g0_cpu)
    if zeros != zeros_cpu:
        problems.append(f"{arch} all-zero gradient leaves: card {zeros}, "
                        f"CPU {zeros_cpu}")
    loss_r, g_r = vg(params, batch, remat=True)
    remat_bitwise = bool(torch.equal(loss_r, loss0)) and _bitwise(
        torch, g_r, g0)
    if not remat_bitwise:
        problems.append(f"{arch}: remat=True not bitwise-equal to "
                        "remat=False")
    del g0_cpu, g_r

    opt = AdamW(lr=GEO_LR[arch])
    step = steps.make_gnn_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    p, s = params, opt.init(params)
    losses, step_ms, after_rerun = [], [], None
    for i in range(GEO_STEPS):
        (p, s, m), ms = timed_call(torch, lambda: step(p, s, batch))
        losses.append(float(m["loss"]))
        step_ms.append(ms)
        if i == GEO_RERUN - 1:
            after_rerun = p
    peak = peak_gib(torch)
    prof = device_items(torch, lambda: step(p, s, batch))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"{arch} train: losses {losses}")
    q, t = params, opt.init(params)
    for _ in range(GEO_RERUN):
        q, t, _ = step(q, t, batch)
    rerun_bitwise = _bitwise(torch, q, after_rerun)
    if not rerun_bitwise:
        problems.append(f"{arch}: {GEO_RERUN}-step rerun not bitwise")

    ef = {"state": ef_init(params)}

    def compress(grads):
        grads, ef["state"] = compress_with_error_feedback(grads, ef["state"])
        return grads

    _, _, m = steps.make_gnn_train_step(cfg, opt, compress=compress)(
        params, opt.init(params), batch)
    ef_loss = float(m["loss"])
    ef_abs = max(float(r.abs().max()) for r in tree_leaves(
        ef["state"].residual))
    if not np.isfinite(ef_loss) or not ef_abs > 0:
        problems.append(f"{arch} EF step: loss {ef_loss}, max |residual| "
                        f"{ef_abs}")
    wall = statistics.median(step_ms[1:])
    record = dict(
        arch=arch, params=count_params(params),
        serve=dict(wall_ms=serve_ms, **serve_prof),
        err_vs_cpu=err, max_abs_cpu=float(e_cpu.abs().max()),
        rotation_err=rot_err, loss0_card=float(loss0),
        loss0_cpu=float(loss0_cpu), zero_grad_leaves=zeros,
        remat_bitwise=remat_bitwise,
        train=dict(steps=GEO_STEPS, lr=GEO_LR[arch], losses=losses,
                   step_ms=step_ms, wall_ms=wall,
                   molecules_per_s=GEO_MOLS / wall * 1e3,
                   max_memory_gib=peak, rerun_bitwise=rerun_bitwise,
                   **prof),
        ef=dict(loss=ef_loss, max_abs_residual=ef_abs))
    return problems, record


def grouped_grad_check(torch) -> tuple:
    """A G = 2 stacked cora ``gcn_forward`` on the "cuda" backend under
    grad: cora's normalized adjacency and its pattern with seeded random
    values (not symmetric: its backward runs over Aᵀ's own partition),
    each with its own features and weights. Gates: the grouped forward
    with grad on has the bits of the no-grad grouped forward and of each
    member alone; each member's weight gradients have the bits of that
    member differentiated alone."""
    import dataclasses

    import scipy.sparse as sp

    from repro_torch.core.formats import (TriPartition, csr_from_scipy,
                                          csr_to_scipy)
    from repro_torch.core.hybrid_spmm import gcn_forward
    from repro_torch.core.partition import (PartitionConfig,
                                            analyze_and_partition)
    from repro_torch.data.graphs import make_paper_dataset
    from repro_torch.kernels import ops
    from repro_torch.train.steps import masked_xent

    problems = []
    csr, x, _, st = make_paper_dataset("cora", seed=SEED)
    rng = np.random.default_rng(SEED)
    a = csr_to_scipy(csr)
    asym = csr_from_scipy(sp.csr_matrix(
        (rng.random(a.data.shape[0]).astype(np.float32), a.indices,
         a.indptr), shape=a.shape))
    members = [analyze_and_partition(c, PartitionConfig(tile=64))[:2]
               for c in (csr, asym)]
    meta = members[0][1]
    if dataclasses.asdict(members[1][1]) != dataclasses.asdict(meta):
        fail("grouped gradient: the two cora partitions differ in shape")
    stack = TriPartition(*(type(c)(*(np.stack(leaves)
                                     for leaves in zip(*comps)))
                           for c, comps in zip(members[0][0],
                                               zip(*[p for p, _ in
                                                     members]))))
    n = meta.n_rows
    xs = np.stack([x, (rng.random(x.shape) < 0.05).astype(np.float32)])
    ws_np = [np.stack([glorot(rng, st.n_features, HIDDEN)
                       for _ in range(2)]),
             np.stack([glorot(rng, HIDDEN, st.n_classes)
                       for _ in range(2)])]
    ys = torch.from_numpy(rng.integers(0, st.n_classes, (2, n))).cuda()
    masks = torch.from_numpy(rng.random((2, n)) < 0.6).cuda()
    kw = dict(meta=meta, backend="cuda", device="cuda")

    ws = [torch.from_numpy(w).cuda().requires_grad_(True) for w in ws_np]
    c0 = ops.launch_counts()
    out = gcn_forward(stack, xs, ws, **kw)
    grads = torch.autograd.grad(
        sum(masked_xent(out[i], ys[i], masks[i]) for i in range(2)), ws)
    launches = _diff(c0, ops.launch_counts())
    with torch.no_grad():
        grouped = gcn_forward(stack, xs, ws, **kw)
    forward_bitwise = bool(torch.equal(out.detach(), grouped))
    member_bitwise = []
    for i, (part, m) in enumerate(members):
        alone = [torch.from_numpy(w[i]).cuda().requires_grad_(True)
                 for w in ws_np]
        logits = gcn_forward(part, xs[i], alone, meta=m, backend="cuda",
                             device="cuda")
        g = torch.autograd.grad(masked_xent(logits, ys[i], masks[i]), alone)
        member_bitwise.append(
            bool(torch.equal(logits.detach(), grouped[i]))
            and all(bool(torch.equal(a, b[i])) for a, b in zip(g, grads)))
    if not forward_bitwise or not all(member_bitwise):
        problems.append(f"grouped gradient: forward bitwise "
                        f"{forward_bitwise}, members bitwise "
                        f"{member_bitwise}")
    if not any(launches.values()):
        problems.append("grouped gradient: no kernel launched")
    return problems, dict(graph="cora x 2 (normalized; random values)",
                          forward_bitwise=forward_bitwise,
                          members_bitwise=member_bitwise,
                          launches=launches)


def geometric_phase(torch, smi: str) -> tuple:
    """DimeNet and NequIP at their full configs on the molecule cell,
    then the grouped GCN gradient on the card."""
    t0 = time.perf_counter()
    host, cpu_batch, batch = molecule_batches(torch)
    problems, models = [], []
    for arch in ("dimenet", "nequip"):
        p, rec = geometric_model(torch, arch, host, cpu_batch, batch)
        problems += p
        models.append(rec)
        torch.cuda.empty_cache()
    p, grouped = grouped_grad_check(torch)
    problems += p
    record = dict(
        gpu=smi, cell="molecule", molecules=GEO_MOLS,
        atoms_per_molecule=GEO_ATOMS, cutoff=GEO_CUTOFF,
        edges=int(host["edge_src"].shape[0]),
        triplets=int(host["trip_kj"].shape[0]), models=models,
        grouped_grad=grouped,
        reduced=[f"molecule cell: {GEO_MOLS} molecules (batch)"],
        phase_s=time.perf_counter() - t0)
    return problems, record


# ---------------------------------------------------------- sharded layer --
# the sharded layer (repro_torch.{launch.mesh, distributed.{sharding,halo},
# models.moe_ep}) over one NCCL rank on a (1, 1) (data, model) mesh.
# Path A: the reference's distributed GNN cell, gatedgcn at its full
# CONFIG on full_graph_sm, halo ops + remat, AdamW at the cell's 1e-3.
# The graph is the port's make_paper_dataset("cora"): its 12760 CSR
# entries (the cell names 10556 edges) are the edges, in row order
# (receiver = row, sender = column).
SHARD_STEPS, SHARD_RERUN, SHARD_LR = 20, 3, 1e-3
EDGE_FEAT = 4                       # the reference cell's edge width
# Path B: qwen3-moe-235b-a22b's expert-parallel MoE layer at full width
# (d 4096, 128 experts, d_ff 1536, top-8) on train_4k's 4096 tokens; at
# f32 with capacity factor E / k = 16 nothing drops; times in bf16 at
# the config's 1.25; then 2 layers (depth cut from 94) of the forward
MOE_ARCH, MOE_TOKENS, MOE_LAYERS, MOE_TIMED = ("qwen3-moe-235b-a22b", 4096,
                                               2, 5)
# the CPU check: 4 gloo ranks on a (2, 2) mesh, gatedgcn's SMOKE config,
# on a graph that keeps the halo contract at 4 and 8 shards (an SBM with
# every edge inside one of 16 communities, RCM-reordered), against the
# single-rank step within GLOO_TOL after GLOO_STEPS AdamW steps
GLOO_RANKS, GLOO_SHAPE, GLOO_STEPS, GLOO_FEAT = 4, (2, 2), 3, 8
GLOO_TOL = dict(rtol=1e-5, atol=1e-6)
GLOO_TIMEOUT_S = 300.0


def _edges(csr) -> tuple:
    """(senders, receivers) of a CSR in row order."""
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    return csr.indices.astype(np.int64), rows.astype(np.int64)


def halo_fractions(csr) -> dict:
    """The share of senders outside the +-1-shard halo of their edge's
    position (``validate_locality``) at 4 and 8 shards, unreordered and
    RCM-reordered: a finding, not a gate."""
    from repro_torch.core.reorder import reorder
    from repro_torch.distributed.halo import validate_locality

    out = {}
    for name, a in (("natural", csr), ("rcm", reorder(csr, "rcm")[0])):
        s, _ = _edges(a)
        n, e = a.shape[0], s.shape[0]
        pos = np.arange(e) * n // e
        out[name] = {k: validate_locality(s, pos, n, k) for k in (4, 8)}
    return out


def gnn_batch(csr, x, labels, seed) -> dict:
    """A full-graph batch (numpy): the CSR's edges, seeded edge features
    of the cell's width, every node labelled."""
    s, r = _edges(csr)
    rng = np.random.default_rng(seed)
    return {"senders": s, "receivers": r, "node_feat": x,
            "edge_feat": rng.standard_normal(
                (s.shape[0], EDGE_FEAT)).astype(np.float32),
            "labels": labels.astype(np.int64),
            "node_mask": np.ones(x.shape[0], np.float32)}


def gatedgcn_path(torch, mesh, smi: str, dev="cuda") -> tuple:
    """Path A: the halo-sharded step against the unsharded one, step for
    step (loss and parameters ``torch.equal``), a bitwise rerun, losses
    falling; times, a profile of one step (launches, NCCL kernels, the
    exchange's device share) and the exchanges per step."""
    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import make_paper_dataset
    from repro_torch.distributed.halo import make_halo_ops
    from repro_torch.distributed.sharding import graph_batch_specs, shard_tree
    from repro_torch.launch.mesh import all_axes
    from repro_torch.models.gnn import gatedgcn_init
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamW

    problems = []
    cfg = get_arch("gatedgcn").config
    csr, x, y, _ = make_paper_dataset("cora", scale=1.0, seed=SEED)
    host = gnn_batch(csr, x, y, SEED)
    full = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    local = shard_tree(full, graph_batch_specs(mesh, full), mesh)
    gops = make_halo_ops(mesh, all_axes(mesh))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = gatedgcn_init(cfg, x.shape[1], EDGE_FEAT, gen, device=dev)
    opt = AdamW(lr=SHARD_LR)
    sharded = steps.make_gnn_train_step(cfg, opt, gops=gops, remat=True)
    plain = steps.make_gnn_train_step(cfg, opt, remat=True)

    torch.cuda.reset_peak_memory_stats()
    p, s = params, opt.init(params)
    q, t = params, opt.init(params)
    losses, step_ms, mismatch, after_rerun = [], [], [], None
    for i in range(SHARD_STEPS):
        calls = gops.exchange.calls
        (p, s, m), ms = timed_call(torch, lambda: sharded(p, s, local))
        exchanges = gops.exchange.calls - calls
        q, t, m_plain = plain(q, t, full)
        losses.append(float(m["loss"]))
        step_ms.append(ms)
        if not (torch.equal(m["loss"], m_plain["loss"])
                and _bitwise(torch, p, q)):
            mismatch.append(i)
        if i == SHARD_RERUN - 1:
            after_rerun = p
    peak = peak_gib(torch)
    if mismatch:
        problems.append(f"gatedgcn halo step != unsharded step at steps "
                        f"{mismatch}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"gatedgcn halo step losses: {losses}")
    r, u = params, opt.init(params)
    for _ in range(SHARD_RERUN):
        r, u, _ = sharded(r, u, local)
    rerun_bitwise = _bitwise(torch, r, after_rerun)
    if not rerun_bitwise:
        problems.append(f"gatedgcn halo step: {SHARD_RERUN}-step rerun not "
                        "bitwise")
    prof = profile_calls(torch, lambda: sharded(p, s, local), calls=1,
                         cpu=False, detail=True)
    per, counts = prof.pop("per_kernel"), prof.pop("per_kernel_calls")
    nccl = {k[:80]: dict(ms=v, launches=counts[k])
            for k, v in per.items() if "nccl" in k.lower()}
    halo_ms = sum(v for k, v in per.items()
                  if "nccl" in k.lower() and "sendrecv" in k.lower())
    wall = statistics.median(step_ms[1:])
    record = dict(
        gpu=smi, arch="gatedgcn", cell="full_graph_sm", graph="cora",
        nodes=int(x.shape[0]), edges=int(host["senders"].shape[0]),
        d_feat=int(x.shape[1]), edge_feat=EDGE_FEAT, layers=cfg.n_layers,
        d_hidden=cfg.d_hidden, classes=cfg.n_classes, mesh=[1, 1],
        steps=SHARD_STEPS, lr=SHARD_LR, losses=losses, step_ms=step_ms,
        wall_ms=wall, exchanges_per_step=exchanges,
        equal_to_unsharded=not mismatch, rerun_bitwise=rerun_bitwise,
        max_memory_gib=peak, device_ms=prof["device_ms_per_infer"],
        kernels=prof["kernels_per_infer"], busy_share=prof["busy_share"],
        nccl=nccl, halo_exchange_ms=halo_ms,
        halo_exchange_share=halo_ms / prof["device_ms_per_infer"],
        top=prof["top"])
    return problems, record


def moe_path(torch, mesh, smi: str, dev="cuda") -> tuple:
    """Path B: ``moe_ffn_ep`` at full width against ``moe_ffn`` (f32 at
    capacity factor 16: bitwise; bf16 at 1.25: values and gradients
    bitwise, times), then 2 layers of the forward, the prefill and a
    decode step with and without ``moe_shardings={"ep_mesh": ...}``
    (bitwise, times)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.moe_ep import moe_ffn_ep
    from repro_torch.tree import tree_map

    problems = []
    cfg = get_arch(MOE_ARCH).config
    ep = {"ep_mesh": mesh, "dp": ("data",), "mdl": "model"}

    def ep_ffn(xx, p, c):
        return moe_ffn_ep(xx, p, c, mesh, dp_axes=ep["dp"],
                          mdl_axis=ep["mdl"])

    gen = torch.Generator(device=dev).manual_seed(SEED)
    lp = {k: v for k, v in T.init_layer_params(cfg, gen).items()
          if k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.randn((MOE_TOKENS, cfg.d_model), generator=gen, device=dev)
    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        want, f32_ref_ms = timed_call(torch, lambda: T.moe_ffn(x, lp, nodrop))
        got, f32_ms = timed_call(torch, lambda: ep_ffn(x, lp, nodrop))
    f32_peak = peak_gib(torch)
    f32_equal = bool(torch.equal(got, want))
    if not f32_equal or not bool(torch.isfinite(got).all()):
        problems.append(f"moe_ffn_ep f32 (no drop) != moe_ffn: "
                        f"{max_err(got, want)}")
    del want, got
    torch.cuda.empty_cache()

    lb = tree_map(lambda v: v.to(torch.bfloat16), lp)
    xb = x.to(torch.bfloat16)
    times = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for name, fn in (("moe_ffn", lambda: T.moe_ffn(xb, lb, cfg)),
                         ("moe_ffn_ep", lambda: ep_ffn(xb, lb, cfg))):
            times[name] = wall_ms(torch, fn)
        ep_items = device_items(torch, lambda: ep_ffn(xb, lb, cfg))
    bf16_peak = peak_gib(torch)
    ct = torch.randn(xb.shape, generator=gen, device=dev).to(xb.dtype)
    grads = []
    for fn in (T.moe_ffn, ep_ffn):
        p = {k: v.clone().requires_grad_(True) for k, v in lb.items()}
        xx = xb.clone().requires_grad_(True)
        out = fn(xx, p, cfg)
        (out.float() * ct.float()).sum().backward()
        grads.append([out.detach(), xx.grad] + [p[k].grad for k in sorted(p)])
    bf16_equal = all(torch.equal(a, b) for a, b in zip(*grads))
    if not bf16_equal:
        problems.append("moe_ffn_ep bf16 values or gradients != moe_ffn's")
    del grads, lb, xb, lp, x
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(cfg, n_layers=MOE_LAYERS)
    params = T.init_params(cfg2, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (1, MOE_TOKENS), generator=gen,
                           device=dev)
    fwd = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for name, kw in (("unsharded", {}), ("ep_mesh", {"moe_shardings":
                                                         ep})):
            outs, ms = [], []
            for _ in range(MOE_TIMED):
                h, t_ms = timed_call(torch, lambda: T.forward(
                    params, tokens, cfg2, remat=False, **kw))
                outs.append(h)
                ms.append(t_ms)
            fwd[name] = dict(outs=outs, ms=ms)
    fwd_peak = peak_gib(torch)
    a, b = fwd["unsharded"]["outs"], fwd["ep_mesh"]["outs"]
    fwd_equal = all(torch.equal(a[0], h) for h in a + b)
    if not fwd_equal or not bool(torch.isfinite(a[0]).all()):
        problems.append(f"{MOE_ARCH} {MOE_LAYERS}-layer forward with ep_mesh "
                        "!= without (or reruns differ)")
    served = {}
    for name, kw in (("unsharded", {}), ("ep_mesh", {"moe_shardings": ep})):
        (h, cache), p_ms = timed_call(torch, lambda: T.prefill(
            params, tokens, cfg2, max_len=MOE_TOKENS + 1, **kw))
        (logits, _), d_ms = timed_call(torch, lambda: T.decode_step(
            params, cache, tokens[:, -1:], cfg2, **kw))
        served[name] = dict(outs=[h, logits] + [cache[k] for k in sorted(
            cache)], prefill_ms=p_ms, decode_ms=d_ms)
    serve_equal = all(torch.equal(u, v) for u, v in zip(
        served["unsharded"]["outs"], served["ep_mesh"]["outs"]))
    if not serve_equal:
        problems.append(f"{MOE_ARCH} prefill / decode_step with ep_mesh != "
                        "without")
    record = dict(
        gpu=smi, arch=MOE_ARCH, d_model=cfg.d_model, experts=cfg.n_experts,
        e_local=cfg.n_experts, d_ff=cfg.d_ff, top_k=cfg.top_k,
        tokens=MOE_TOKENS,
        f32_nodrop=dict(capacity_factor=nodrop.capacity_factor,
                        equal=f32_equal, ms=f32_ms, moe_ffn_ms=f32_ref_ms,
                        max_memory_gib=f32_peak),
        bf16=dict(capacity_factor=cfg.capacity_factor, ms=times,
                  values_and_grads_equal=bf16_equal,
                  max_memory_gib=bf16_peak, **ep_items),
        forward=dict(layers=MOE_LAYERS, tokens=MOE_TOKENS, dtype="bf16",
                     equal=fwd_equal, ms={k: v["ms"] for k, v in fwd.items()},
                     max_memory_gib=fwd_peak),
        prefill_decode=dict(equal=serve_equal, **{
            k: dict(prefill_ms=v["prefill_ms"], decode_ms=v["decode_ms"])
            for k, v in served.items()}))
    del params, fwd, a, b, served
    torch.cuda.empty_cache()
    return problems, record


# Paths C-F: tensor-parallel, sequence-parallel and FSDP execution of the
# LM and the sharded energy loss, over the same one-rank NCCL group (every
# collective of the plan issued, a copy over one rank): each sharded step
# against the unsharded step from the same state, bitwise
TP_SEQ, TP_LR, TP_XENT = 4096, 1e-4, 256
# (name, arch, layers kept (None: all), steps, MoE dict); each under its
# CONFIG's parallelism: "tp_fsdp", granite-8b's "fsdp", "tp_fsdp"
TP_PATHS = (("C", "qwen3-0.6b", None, 3, None),
            ("D", "granite-8b", 4, 3, None),
            ("E", "mixtral-8x7b", 1, 1, "tp"))
ENERGY_STEPS = 3


def device_share(prof, mark: str) -> tuple:
    """(device ms per call of the items whose name holds ``mark``, their
    share of the call's device time) from a ``profile_calls(detail=True)``
    record."""
    ms = sum(v for k, v in prof["per_kernel"].items()
             if mark.lower() in k.lower())
    dev = prof["device_ms_per_infer"]
    return ms, (ms / dev if dev else 0.0)


def _step_profile(torch, fn) -> dict:
    """Device ms, kernels, busy share, the NCCL kernels' ms and share and
    the device-to-device copies' (over one rank NCCL moves an
    all-gather, reduce-scatter or all-reduce as a copy, no kernel) of
    one call of ``fn`` (its outputs dropped)."""
    prof = profile_calls(torch, fn, calls=1, cpu=False, detail=True)
    ms, share = device_share(prof, "nccl")
    copy_ms, copy_share = device_share(prof, "Memcpy DtoD")
    return dict(device_ms=prof["device_ms_per_infer"],
                kernels=prof["kernels_per_infer"],
                busy_share=prof["busy_share"], nccl_ms=ms, nccl_share=share,
                dtod_ms=copy_ms, dtod_share=copy_share, top=prof["top"][:5])


def lm_tp_path(torch, mesh, smi: str, name: str, arch: str, layers,
               n_steps: int, moe, dev="cuda") -> tuple:
    """Paths C-E: ``arch`` at full width (depth cut to ``layers``) under
    its ``parallelism`` on the (1, 1) mesh, given the reference's
    ``act_constraint`` for it, 1 x TP_SEQ tokens: ``n_steps`` AdamW
    steps of the sharded train step (parameters placed by ``shard_tree``),
    each from the unsharded step's state and ``torch.equal`` to it (loss
    and every parameter leaf); the collectives a step (``tp.COUNTS``)
    against ``LMPlan.predicted_counts``; wall and device ms, the NCCL
    kernels' share and peak GiB of both steps."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  lm_param_specs,
                                                  opt_state_specs, shard_tree,
                                                  tp_expert_shardings)
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.steps import make_lm_train_step
    from repro_torch.tree import tree_leaves

    problems = []
    cfg = get_arch(arch).config
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    ms = tp_expert_shardings(mesh) if moe == "tp" else None
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = T.init_params(cfg, gen, device=dev)
    specs = lm_param_specs(cfg, mesh, params)
    stream = TokenStream(cfg.vocab, 1, TP_SEQ, seed=SEED)
    opt = AdamW(lr=TP_LR, weight_decay=0.01)
    plain = make_lm_train_step(cfg, opt, remat=True, xent_chunk=TP_XENT)
    act = NamedSharding(mesh, tp.residual_spec(cfg, mesh))
    sharded = make_lm_train_step(cfg, opt, remat=True, xent_chunk=TP_XENT,
                                 act_constraint=act, moe_shardings=ms)
    plan = tp.LMPlan(cfg, mesh, ms)
    strategy = plan.strategy
    predicted = plan.predicted_counts(TP_SEQ, TP_XENT, step=True)

    # one state at a time beside the step's own (mixtral's 1.7 B
    # parameters and their AdamW moments are 27 GB): the sharded step
    # from the state's blocks, then the unsharded step from the state
    p, s = params, None                # None: AdamW's zeros, made at use
    losses, ms_plain, ms_sharded, mismatch, counts = [], [], [], [], []
    peak = {}
    for i in range(n_steps):
        batch = _batch(torch, stream.batch_at(i))
        lp = shard_tree(p, specs, mesh)
        ls = (opt.init(lp) if s is None
              else shard_tree(s, opt_state_specs(specs), mesh))
        torch.cuda.reset_peak_memory_stats()
        tp.reset_counts()
        (lq, lt, lm), t_sharded = timed_call(
            torch, lambda: sharded(lp, ls, batch))
        counts.append(dict(tp.COUNTS))
        peak["sharded"] = max(peak.get("sharded", 0.0), peak_gib(torch))
        del lp, ls, lt
        torch.cuda.empty_cache()
        s_in = opt.init(p) if s is None else s
        torch.cuda.reset_peak_memory_stats()
        (q, t, m), t_plain = timed_call(torch, lambda: plain(p, s_in,
                                                              batch))
        peak["unsharded"] = max(peak.get("unsharded", 0.0),
                                peak_gib(torch))
        del s_in
        losses.append(float(m["loss"]))
        ms_plain.append(t_plain)
        ms_sharded.append(t_sharded)
        if not (torch.equal(lm["loss"], m["loss"]) and _bitwise(torch, lq,
                                                                q)):
            mismatch.append(i)
        del lq
        p, s = q, t
        torch.cuda.empty_cache()
    if mismatch:
        problems.append(f"path {name} ({arch} {strategy}): sharded step != "
                        f"unsharded at steps {mismatch}")
    if not all(np.isfinite(losses)):
        problems.append(f"path {name}: losses {losses}")
    if any(c != predicted for c in counts):
        problems.append(f"path {name}: collectives {counts} != the plan's "
                        f"{predicted}")
    # a step from the last state profiled on each path, its outputs
    # dropped (over one rank each block is the whole leaf, so the
    # sharded step takes the state itself)
    batch = _batch(torch, stream.batch_at(0))
    prof_plain = _step_profile(torch, lambda: plain(p, s, batch) and None)
    prof_sharded = _step_profile(torch, lambda: sharded(p, s, batch)
                                 and None)
    record = dict(
        path=name, gpu=smi, arch=arch, strategy=strategy,
        layers=cfg.n_layers, d_model=cfg.d_model, batch=1, seq=TP_SEQ,
        params_m=sum(int(v.numel()) for v in tree_leaves(params)) / 1e6,
        plan=dict(attn=plan.attn, ffn=plan.ffn, moe=plan.moe,
                  head=plan.head, act=repr(plan.act)),
        steps=n_steps, losses=losses, equal_to_unsharded=not mismatch,
        collectives=counts[-1], predicted_collectives=predicted,
        sharded=dict(step_ms=ms_sharded, wall_ms=statistics.median(
            ms_sharded), max_memory_gib=peak["sharded"], **prof_sharded),
        unsharded=dict(step_ms=ms_plain, wall_ms=statistics.median(ms_plain),
                       max_memory_gib=peak["unsharded"], **prof_plain))
    del params, p, s
    torch.cuda.empty_cache()
    return problems, record


def energy_path(torch, mesh, smi: str, dev="cuda") -> tuple:
    """Path F: DimeNet and NequIP at full config on the molecule cell,
    the halo ops over the one rank: ENERGY_STEPS AdamW steps of the
    sharded energy step, each from the unsharded step's state and
    ``torch.equal`` to it; wall and device ms, exchanges and psums a
    step, the NCCL kernels' share, peak GiB."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import tp
    from repro_torch.distributed.halo import make_halo_ops
    from repro_torch.distributed.sharding import graph_batch_specs, shard_tree
    from repro_torch.launch.mesh import all_axes
    from repro_torch.models import dimenet, nequip
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamW

    problems, records = [], []
    host, _, batch = molecule_batches(torch)
    local = shard_tree(batch, graph_batch_specs(mesh, batch), mesh)
    gops = make_halo_ops(mesh, all_axes(mesh))
    for arch in ("dimenet", "nequip"):
        cfg = get_arch(arch).config
        init = dimenet.dimenet_init if arch == "dimenet" else \
            nequip.nequip_init
        params = init(cfg, torch.Generator(device=dev).manual_seed(SEED),
                      device=dev)
        opt = AdamW(lr=GEO_LR[arch])
        plain = steps.make_gnn_train_step(cfg, opt)
        sharded = steps.make_gnn_train_step(cfg, opt, gops=gops)
        torch.cuda.reset_peak_memory_stats()
        p, s = params, opt.init(params)
        losses, ms_plain, ms_sharded, mismatch, per_step = [], [], [], [], []
        for i in range(ENERGY_STEPS):
            (q, t, m), t_plain = timed_call(torch, lambda: plain(p, s, batch))
            calls = gops.exchange.calls
            tp.reset_counts()
            (lq, _, lm), t_sh = timed_call(torch, lambda: sharded(p, s,
                                                                  local))
            per_step.append(dict(exchanges=gops.exchange.calls - calls,
                                 **dict(tp.COUNTS)))
            losses.append(float(m["loss"]))
            ms_plain.append(t_plain)
            ms_sharded.append(t_sh)
            if not (torch.equal(lm["loss"], m["loss"])
                    and _bitwise(torch, lq, q)):
                mismatch.append(i)
            p, s = q, t
        peak = peak_gib(torch)
        if mismatch:
            problems.append(f"path F {arch}: sharded energy step != "
                            f"unsharded at steps {mismatch}")
        if not all(np.isfinite(losses)):
            problems.append(f"path F {arch}: losses {losses}")
        if any(c.get("all_reduce") != 2 for c in per_step):
            problems.append(f"path F {arch}: {per_step} (a step sums the "
                            "energies and their cotangent over the group)")
        prof_plain = _step_profile(torch, lambda: plain(p, s, batch)
                                   and None)
        prof_sharded = _step_profile(torch, lambda: sharded(p, s, local)
                                     and None)
        records.append(dict(
            path="F", gpu=smi, arch=arch, mols=GEO_MOLS,
            atoms=int(host["z"].shape[0]),
            edges=int(host["edge_src"].shape[0]),
            triplets=int(host["trip_kj"].shape[0]), steps=ENERGY_STEPS,
            losses=losses, equal_to_unsharded=not mismatch,
            collectives=per_step[-1], max_memory_gib=peak,
            sharded=dict(step_ms=ms_sharded, wall_ms=statistics.median(
                ms_sharded), **prof_sharded),
            unsharded=dict(step_ms=ms_plain, wall_ms=statistics.median(
                ms_plain), **prof_plain)))
        del params, p, s, q, lq
        torch.cuda.empty_cache()
    return problems, records


def gloo_batch(seed: int = SEED) -> dict:
    """The CPU check's full-graph batch (numpy)."""
    from repro_torch.core.formats import csr_from_scipy
    from repro_torch.core.reorder import reorder
    from repro_torch.data.graphs import sbm_graph

    a = sbm_graph(1024, 8192, n_communities=16, intra_frac=1.0,
                  power_law=False, seed=seed)
    csr = reorder(csr_from_scipy(a), "rcm")[0]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((csr.shape[0], GLOO_FEAT)).astype(np.float32)
    return gnn_batch(csr, x, rng.integers(0, 4, csr.shape[0]), seed)


def gloo_run(rank, world, params, batch, steps_n) -> dict:
    """One rank of the CPU check (or, on one rank, the unsharded step):
    ``steps_n`` AdamW steps of gatedgcn's SMOKE config; losses and the
    parameters after."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.convert import tree_from_numpy
    from repro_torch.distributed.halo import make_halo_ops
    from repro_torch.distributed.sharding import graph_batch_specs, shard_tree
    from repro_torch.launch.mesh import all_axes, make_mesh
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamW
    from repro_torch.tree import tree_leaves

    cfg = get_arch("gatedgcn").smoke
    full = {k: torch.from_numpy(v) for k, v in batch.items()}
    gops = None
    if world > 1:
        mesh = make_mesh(GLOO_SHAPE, ("data", "model"), "cpu")
        gops = make_halo_ops(mesh, all_axes(mesh))
        full = shard_tree(full, graph_batch_specs(mesh, full), mesh)
    opt = AdamW(lr=SHARD_LR)
    step = steps.make_gnn_train_step(cfg, opt, gops=gops, remat=True)
    p = tree_from_numpy(params, "cpu")
    s = opt.init(p)
    losses = []
    for _ in range(steps_n):
        p, s, m = step(p, s, full)
        losses.append(float(m["loss"]))
    return dict(losses=losses, params=[v.numpy() for v in tree_leaves(p)])


def gloo_check(torch) -> tuple:
    """Path A on the CPU across ranks: 4 gloo ranks (processes) on a
    (2, 2) mesh against the single-rank step in this process."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.launch.local import run_ranks
    from repro_torch.models.gnn import gatedgcn_init
    from repro_torch.tree import tree_map

    problems = []
    t0 = time.perf_counter()
    batch = gloo_batch()
    n, e = batch["node_feat"].shape[0], batch["senders"].shape[0]
    for key in ("senders", "receivers"):
        for k in (GLOO_RANKS, 2 * GLOO_RANKS):
            blocks = batch[key] // (n // k) - np.arange(e) // (e // k)
            if np.abs(blocks).max() > 1:
                problems.append(f"gloo check graph: {key} leave the halo "
                                f"at {k} shards")
    params = tree_map(lambda v: v.numpy(), gatedgcn_init(
        get_arch("gatedgcn").smoke, GLOO_FEAT, EDGE_FEAT,
        torch.Generator().manual_seed(SEED), device="cpu"))
    want = gloo_run(0, 1, params, batch, GLOO_STEPS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as d:
        ranks = run_ranks(gloo_run, GLOO_RANKS, params, batch, GLOO_STEPS,
                          backend="gloo", store_dir=d,
                          timeout_s=GLOO_TIMEOUT_S)
    err = 0.0
    for r in ranks:
        for a, b in zip([r["losses"]] + r["params"],
                        [want["losses"]] + want["params"]):
            a, b = np.asarray(a), np.asarray(b)
            err = max(err, float(np.abs(a - b).max()))
            if not np.allclose(a, b, **GLOO_TOL):
                problems.append("gloo check: a rank's losses or parameters "
                                "leave the single-rank step's tolerance")
                break
    same = all(np.array_equal(a, b) for r in ranks[1:]
               for a, b in zip(r["params"], ranks[0]["params"]))
    if not same:
        problems.append("gloo check: ranks hold different parameters")
    record = dict(device="cpu", backend="gloo", ranks=GLOO_RANKS,
                  mesh=list(GLOO_SHAPE), config="gatedgcn SMOKE",
                  nodes=int(n), edges=int(e), steps=GLOO_STEPS,
                  losses=ranks[0]["losses"], single_rank=want["losses"],
                  max_abs_err=err, ranks_equal=same,
                  seconds=time.perf_counter() - t0)
    return problems, record


# the CPU check of paths C-F: SMOKE configs on gloo ranks against one
# process's unsharded step, within GLOO_TOL. (arch, strategy, mesh, MoE
# dict, config changes): mixtral's d_ff 96 splits over 3 model ranks
GLOO_LM = (("qwen3-0.6b", (2, 2), None, {}),
           ("granite-8b", (2, 2), None, {"parallelism": "fsdp"}),
           ("mixtral-8x7b", (1, 3), "tp", {"d_ff": 96}))
GLOO_LM_SHAPE = (4, 24)
GLOO_LM_KW = dict(q_chunk=8, k_chunk=8, xent_chunk=8, compute_dtype=None)
# 64 atoms, 200 edges, 656 triplets: each divides over 4 ranks, and
# every index lies within one shard of its position (the halo contract)
GLOO_MOLS = dict(n_mols=8, atoms_per_mol=8, cutoff=3.0, seed=1)


def gloo_lm_inputs(arch, kw) -> tuple:
    """(SMOKE config with ``kw``, numpy params from the port's seeded
    init, numpy batch)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_arch(arch).smoke, **kw)
    params = tree_map(lambda v: v.numpy(), T.init_params(
        cfg, torch.Generator().manual_seed(SEED), "cpu"))
    b, s = GLOO_LM_SHAPE
    tok = np.random.default_rng(SEED).integers(0, cfg.vocab, (b, s + 1))
    return cfg, params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def gloo_mol_inputs(arch) -> tuple:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import random_molecules
    from repro_torch.models import dimenet, nequip
    from repro_torch.tree import tree_map

    cfg = get_arch(arch).smoke
    init = dimenet.dimenet_init if arch == "dimenet" else nequip.nequip_init
    fields = (dimenet.MoleculeBatch if arch == "dimenet"
              else nequip.AtomGraph)._fields[:-1]
    mols = random_molecules(**GLOO_MOLS)
    batch = {k: mols[k] for k in fields}
    batch["energy"] = np.random.default_rng(SEED).standard_normal(
        GLOO_MOLS["n_mols"]).astype(np.float32)
    params = tree_map(lambda v: v.numpy(), init(
        cfg, torch.Generator().manual_seed(SEED), device="cpu"))
    return cfg, params, batch


def gloo_lm_run(rank, world, shape, cfg, moe, params, batch) -> dict:
    """The LM loss and its gradients (gathered to whole leaves): on one
    rank without a mesh, else sharded on a ``shape`` mesh under the
    config's ``parallelism``."""
    import torch

    from repro_torch.convert import tree_from_numpy
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.tp import residual_spec
    from repro_torch.launch.mesh import all_axes, data_axes, make_mesh
    from repro_torch.train.steps import make_lm_value_and_grad
    from repro_torch.tree import tree_leaves

    full = tree_from_numpy(params, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if world == 1:
        loss, grads = make_lm_value_and_grad(cfg, **GLOO_LM_KW)(full, tb)
    else:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        specs = shd.lm_param_specs(cfg, mesh, full)
        ax = (all_axes(mesh) if cfg.parallelism == "fsdp"
              else data_axes(mesh))
        lb = shd.shard_tree(tb, {k: shd.P(ax, None) for k in tb}, mesh)
        ms = shd.tp_expert_shardings(mesh) if moe == "tp" else None
        act = shd.NamedSharding(mesh, residual_spec(cfg, mesh))
        fn = make_lm_value_and_grad(cfg, act_constraint=act,
                                    moe_shardings=ms, **GLOO_LM_KW)
        loss, grads = fn(shd.shard_tree(full, specs, mesh), lb)
        grads = shd.gather_tree(grads, specs, mesh)
    return dict(loss=float(loss),
                grads=[g.cpu().numpy() for g in tree_leaves(grads)])


def gloo_energy_run(rank, world, cfg, params, batch, steps_n) -> dict:
    """``steps_n`` AdamW steps of the energy step: on one rank unsharded,
    else over the halo ops on a (2, 2) mesh; losses and parameters."""
    import torch

    from repro_torch.convert import tree_from_numpy
    from repro_torch.distributed.halo import make_halo_ops
    from repro_torch.distributed.sharding import graph_batch_specs, shard_tree
    from repro_torch.launch.mesh import all_axes, make_mesh
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamW
    from repro_torch.tree import tree_leaves

    full = {k: torch.from_numpy(v) for k, v in batch.items()}
    gops = None
    if world > 1:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        gops = make_halo_ops(mesh, all_axes(mesh))
        full = shard_tree(full, graph_batch_specs(mesh, full), mesh)
    opt = AdamW(lr=SHARD_LR)
    step = steps.make_gnn_train_step(cfg, opt, gops=gops)
    p = tree_from_numpy(params, "cpu")
    s = opt.init(p)
    losses = []
    for _ in range(steps_n):
        p, s, m = step(p, s, full)
        losses.append(float(m["loss"]))
    return dict(losses=losses,
                params=[v.cpu().numpy() for v in tree_leaves(p)])


def gloo_jobs(rank, world, todo) -> list:
    """[fn(rank, world, *args) for (fn name, args) in ``todo``]."""
    return [globals()[name](rank, world, *args) for name, args in todo]


def gloo_tp_check(torch) -> tuple:
    """Paths C-F across ranks on the CPU: qwen3-0.6b-smoke ("tp_fsdp")
    and granite-smoke ("fsdp") on (2, 2), mixtral-smoke with TP inside
    its 4 experts on (1, 3), DimeNet and NequIP SMOKE energy steps on 4
    ranks; each against one process's unsharded step."""
    import concurrent.futures
    import tempfile

    from repro_torch.launch.local import run_ranks

    problems, rows = [], []
    t0 = time.perf_counter()
    todo, want = {}, []
    for arch, shape, moe, kw in GLOO_LM:
        cfg, params, batch = gloo_lm_inputs(arch, kw)
        args = (shape, cfg, moe, params, batch)
        todo.setdefault(int(np.prod(shape)), []).append(("gloo_lm_run",
                                                         args))
        want.append((f"{arch} {cfg.parallelism} {shape}",
                     int(np.prod(shape)),
                     len(todo[int(np.prod(shape))]) - 1,
                     gloo_lm_run(0, 1, *args)))
    for arch in ("dimenet", "nequip"):
        cfg, params, batch = gloo_mol_inputs(arch)
        args = (cfg, params, batch, GLOO_STEPS)
        todo[4].append(("gloo_energy_run", args))
        want.append((f"{arch} energy (2, 2)", 4, len(todo[4]) - 1,
                     gloo_energy_run(0, 1, *args)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as d, \
            concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
        futs = {w: pool.submit(run_ranks, gloo_jobs, w, jobs,
                               backend="gloo", store_dir=d,
                               timeout_s=GLOO_TIMEOUT_S)
                for w, jobs in todo.items()}
        got = {w: f.result() for w, f in futs.items()}
    for label, world, i, single in want:
        err, ok = 0.0, True
        for r in got[world]:
            res = r[i]
            pairs = ([(res["loss"], single["loss"])]
                     + list(zip(res["grads"], single["grads"]))
                     if "grads" in res else
                     [(res["losses"], single["losses"])]
                     + list(zip(res["params"], single["params"])))
            for a, b in pairs:
                a, b = np.asarray(a), np.asarray(b)
                err = max(err, float(np.abs(a - b).max()))
                ok = ok and bool(np.allclose(a, b, **GLOO_TOL))
        if not ok:
            problems.append(f"gloo check {label}: a rank leaves the "
                            "single-process step's tolerance")
        rows.append(dict(case=label, ranks=world, max_abs_err=err,
                         within_tol=ok))
    return problems, dict(device="cpu", backend="gloo", cases=rows,
                          seconds=time.perf_counter() - t0)


def sharded_phase(torch, smi: str, dev="cuda") -> tuple:
    """Paths A-F over one NCCL rank on the card (``dev`` "cpu": one gloo
    rank, for a rehearsal), then the gloo checks on the CPU, and cora's
    out-of-halo fractions."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.data.graphs import make_paper_dataset
    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    backend = "nccl" if dev == "cuda" else "gloo"
    if dev == "cuda":
        torch.cuda.set_device(0)       # the mesh's device, before the mesh
    dist.init_process_group(backend, init_method=f"file://{store}/store",
                            rank=0, world_size=1, device_id=(
                                torch.device("cuda", 0) if dev == "cuda"
                                else None))
    tp_paths = []
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        problems, gnn = gatedgcn_path(torch, mesh, smi, dev)
        torch.cuda.empty_cache()
        p, moe = moe_path(torch, mesh, smi, dev)
        problems += p
        for name, arch, layers, n_steps, moe_dict in TP_PATHS:
            p, rec = lm_tp_path(torch, mesh, smi, name, arch, layers,
                                n_steps, moe_dict, dev)
            problems += p
            tp_paths.append(rec)
        p, energy = energy_path(torch, mesh, smi, dev)
        problems += p
        tp_paths += energy
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    p, gloo = gloo_check(torch)
    problems += p
    p, gloo_tp = gloo_tp_check(torch)
    problems += p
    csr = make_paper_dataset("cora", scale=1.0, seed=SEED)[0]
    record = dict(gpu=smi, backend=backend, world_size=1, gatedgcn=gnn,
                  moe=moe, tp_paths=tp_paths, gloo_check=gloo,
                  gloo_tp_check=gloo_tp,
                  cora_out_of_halo=halo_fractions(csr),
                  phase_s=time.perf_counter() - t0)
    return problems, record


# Paths G-K: sharded serving (``launch/specs.py`` cells; prefill and
# decode under the serving plan, "tp_fsdp") over a one-rank NCCL group on
# a (1, 1) mesh, each against the unsharded passes on the same bf16
# parameters, bitwise. (name, arch, layers kept (None: all), MoE variants)
SERVE_PATHS = (("G", "qwen3-0.6b", None, (None,)),
               ("H", "mixtral-8x7b", 2, ("ep", "tp")),
               ("I", "granite-8b", 4, (None,)))
# the cells' batches cut to fit one card (the shapes kept): prefill_32k
# 32 -> 1; decode_32k 128 -> 8, its cache filled by a prefill of
# SERVE_PROMPT tokens a sequence (past mixtral's 4096 window, so the
# ring rolls by 63; prefill_32k's 32768 tokens roll by 0), then
# SERVE_DECODE tokens decoded
SERVE_PREFILL_BATCH, SERVE_DECODE_BATCH = 1, 8
SERVE_PROMPT, SERVE_DECODE = 4159, 4
# path J: long_500k (batch 1, 524288 slots) at qwen3-0.6b's full width,
# depth 28 -> 2; one token decoded into the empty cache
LONG_LAYERS = 2
# the gloo check of paths G-J (CPU): SMOKE configs, prefill of
# GLOO_SERVE_SHAPE[1] - 2 tokens into GLOO_SERVE_SLOTS slots and 2
# decodes at f32 on each mesh, against one process's unsharded passes.
# (arch, MoE dict, config changes): mixtral's 3 experts keep TP inside
# them on 2 and 4 model ranks; qwen3-moe at E / k has no drop
GLOO_SERVE = (("qwen3-0.6b", None, {}), ("granite-8b", None, {}),
              ("mixtral-8x7b", "tp", {"n_experts": 3}),
              ("qwen3-moe-235b-a22b", "ep", {"capacity_factor": 4.0}))
GLOO_SERVE_MESHES = ((2, 2), (1, 4), (4, 1))
GLOO_SERVE_SHAPE, GLOO_SERVE_SLOTS = (4, 22), 24


def serving_arch(name: str, layers):
    """The arch with its depth cut to ``layers`` (None: kept)."""
    import dataclasses

    from repro_torch.configs import get_arch

    arch = get_arch(name)
    if layers:
        arch = dataclasses.replace(arch, config=dataclasses.replace(
            arch.config, n_layers=layers))
    return arch


def serving_progs(arch, cells, mesh, moe) -> dict:
    """{cell name: CellProgram} of ``launch.specs.build_lm_cell``; with
    ``moe`` "tp", each step rebuilt with the tensor-parallel MoE dict
    forced in place of the cell's expert-parallel one."""
    import dataclasses

    from repro_torch.distributed.sharding import tp_expert_shardings
    from repro_torch.distributed.tp import LMPlan
    from repro_torch.launch.specs import build_lm_cell
    from repro_torch.models.transformer import cache_len
    from repro_torch.train import steps

    out = {}
    for cell in cells:
        prog = build_lm_cell(arch, cell, mesh)
        if moe == "tp":
            cfg = dataclasses.replace(arch.config, parallelism="tp_fsdp")
            plan = LMPlan(cfg, mesh, tp_expert_shardings(mesh),
                          batch=cell.global_batch)
            fn = (steps.make_lm_prefill_step(cfg, max_len=cell.seq_len,
                                             plan=plan)
                  if cell.kind == "prefill" else steps.make_lm_decode_step(
                      cfg, k_chunk=min(cache_len(cfg, cell.seq_len), 2048),
                      plan=plan))
            prog = dataclasses.replace(prog, fn=fn)
        out[cell.name] = prog
    return out


def serving_params(torch, cfg, prog, mesh, dev):
    """(the seeded parameters cast to the cell's bf16 structs, this
    rank's blocks of them)."""
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    gen = torch.Generator(device=dev).manual_seed(SEED)
    full = tree_map(lambda v: v.to(torch.bfloat16),
                    T.init_params(cfg, gen, device=dev))
    torch.cuda.empty_cache()
    return full, shard_tree(full, prog.in_specs[0], mesh)


def _counted(torch, fn) -> tuple:
    """(result, host ms, device span ms, the collectives by kind) of one
    call ending in a synchronize; the span is CUDA events recorded on
    the stream before and after it (device time with its idle gaps)."""
    from repro_torch.distributed import tp

    tp.reset_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, start.elapsed_time(end), dict(tp.COUNTS)


def _decode_record(torch, fn, ms: list, flops, batch: int) -> dict:
    """The decode steps' host ms, the median's rates, and the device ms,
    kernels and busy share of one more step (profiled, its output
    dropped)."""
    return dict(device_items(torch, lambda: fn() and None),
                ms_per_token=ms,
                **rates(statistics.median(ms), flops, batch))


def serve_path(torch, mesh, smi: str, name: str, arch_name: str, layers,
               variants, dev="cuda") -> tuple:
    """Paths G-I: the prefill_32k and decode_32k cells of ``arch_name``
    (depth cut to ``layers``) through ``build_lm_cell`` on the (1, 1)
    mesh, once per MoE variant, each against the unsharded prefill and
    decode steps on the same bf16 parameters: logits and caches
    ``torch.equal``. The prefill cell at SERVE_PREFILL_BATCH x its
    32768 tokens (wall ms and device span, tokens/s); the decode cell at
    SERVE_DECODE_BATCH, its cache from the prefill cell's step over
    SERVE_PROMPT tokens, then SERVE_DECODE decodes (wall ms a token,
    one more step profiled). Collectives and peak GiB."""
    from repro_torch.data import TokenStream
    from repro_torch.models.transformer import cache_len
    from repro_torch.train import steps

    problems = []
    arch = serving_arch(arch_name, layers)
    cfg = arch.config
    cells = {c.name: c for c in arch.shapes}
    pre_cell, dec_cell = cells["prefill_32k"], cells["decode_32k"]
    progs = {v: serving_progs(arch, (pre_cell, dec_cell), mesh, v)
             for v in variants}
    full, local = serving_params(torch, cfg, progs[variants[0]][
        pre_cell.name], mesh, dev)
    slots = cache_len(cfg, dec_cell.seq_len)
    plain_pre = steps.make_lm_prefill_step(cfg, max_len=pre_cell.seq_len)
    plain_dec = steps.make_lm_decode_step(cfg, k_chunk=min(slots, 2048))
    seq = pre_cell.seq_len
    toks = torch.from_numpy(TokenStream(cfg.vocab, SERVE_PREFILL_BATCH, seq,
                                        seed=SEED).batch_at(0)["tokens"]
                            ).to(dev)
    pre_flops = lm_flops(cfg, SERVE_PREFILL_BATCH, seq, logits=1)

    def prefill_record(ms, span, **extra):
        return dict(device_span_ms=span, max_memory_gib=peak_gib(torch),
                    **rates(ms, pre_flops, SERVE_PREFILL_BATCH * seq),
                    **extra)

    # the prefill cell: one unsharded call, one per variant
    torch.cuda.reset_peak_memory_stats()
    want, ms, span, _ = _counted(torch, lambda: plain_pre(full, toks))
    record = dict(path=name, gpu=smi, arch=arch_name, layers=cfg.n_layers,
                  d_model=cfg.d_model, strategy="tp_fsdp",
                  parallelism=cfg.parallelism,
                  prefill=dict(cell=pre_cell.name, batch=SERVE_PREFILL_BATCH,
                               cell_batch=pre_cell.global_batch, seq=seq,
                               unsharded=prefill_record(ms, span)),
                  decode=dict(cell=dec_cell.name, batch=SERVE_DECODE_BATCH,
                              cell_batch=dec_cell.global_batch, slots=slots,
                              prompt=SERVE_PROMPT, tokens=SERVE_DECODE),
                  variants={})
    for v in variants:
        fn = progs[v][pre_cell.name].fn
        torch.cuda.reset_peak_memory_stats()
        got, ms, span, counts = _counted(torch, lambda: fn(local, toks))
        equal = _bitwise(torch, got, want)
        if not equal:
            problems.append(f"path {name} ({arch_name}, {v}): the prefill "
                            "cell != the unsharded prefill")
        del got
        record["variants"][str(v)] = dict(prefill=prefill_record(
            ms, span, equal=equal, collectives=counts))
    del want
    torch.cuda.empty_cache()

    # the decode cell: a cache per pass from the prefill cell's step
    stream = TokenStream(cfg.vocab, SERVE_DECODE_BATCH,
                         SERVE_PROMPT + SERVE_DECODE + 1,
                         seed=SEED).batch_at(0)["tokens"]
    prompt = torch.from_numpy(stream[:, :SERVE_PROMPT]).to(dev)
    dec_toks = [torch.from_numpy(stream[:, SERVE_PROMPT + i:
                                        SERVE_PROMPT + i + 1]).to(dev)
                for i in range(SERVE_DECODE + 1)]
    dec_flops = lm_flops(cfg, SERVE_DECODE_BATCH, 1, ctx=slots - 1)
    torch.cuda.reset_peak_memory_stats()
    _, cache = plain_pre(full, prompt)
    outs, ms_plain = [], []
    for tok in dec_toks[:-1]:
        (lg, cache), ms, _, _ = _counted(torch, lambda: plain_dec(
            full, cache, tok))
        outs.append(lg)
        ms_plain.append(ms)
    want = (outs, cache)
    for v in variants:
        pre, dec = (progs[v][c.name].fn for c in (pre_cell, dec_cell))
        (_, mine), pre_ms, _, pre_counts = _counted(torch, lambda: pre(
            local, prompt))
        got, ms_sh, counts = [], [], {}
        for tok in dec_toks[:-1]:
            (lg, mine), ms, _, counts = _counted(torch, lambda: dec(
                local, mine, tok))
            got.append(lg)
            ms_sh.append(ms)
        equal = _bitwise(torch, (got, mine), want)
        if not equal:
            problems.append(f"path {name} ({arch_name}, {v}): the decode "
                            "cell != the unsharded decode steps")
        tok = dec_toks[-1]
        record["variants"][str(v)]["decode"] = dict(
            equal=equal, prompt_prefill_ms=pre_ms,
            prompt_collectives=pre_counts, collectives=counts,
            **_decode_record(torch, lambda: dec(local, mine, tok), ms_sh,
                             dec_flops, SERVE_DECODE_BATCH))
        del mine, got
        torch.cuda.empty_cache()
    tok = dec_toks[-1]
    record["decode"]["unsharded"] = _decode_record(
        torch, lambda: plain_dec(full, cache, tok), ms_plain, dec_flops,
        SERVE_DECODE_BATCH)
    record["decode"]["max_memory_gib"] = peak_gib(torch)
    del want, cache, full, local, outs
    torch.cuda.empty_cache()
    return problems, record


def long_path(torch, mesh, smi: str, dev="cuda") -> tuple:
    """Path J: the long_500k decode cell of qwen3-0.6b (which the
    configs skip for its full attention; built here by ``build_lm_cell``
    directly) at full width and LONG_LAYERS layers: batch 1 (the data
    axes' spec replicated by ``fit_specs``), one token decoded into an
    empty 524288-slot cache, ``torch.equal`` to the unsharded step."""
    from repro_torch.models import transformer as T
    from repro_torch.train import steps

    problems = []
    arch = serving_arch("qwen3-0.6b", LONG_LAYERS)
    cfg = arch.config
    cell = next(c for c in arch.shapes if c.name == "long_500k")
    prog = serving_progs(arch, (cell,), mesh, None)[cell.name]
    full, local = serving_params(torch, cfg, prog, mesh, dev)
    plain = steps.make_lm_decode_step(cfg, k_chunk=min(cell.seq_len, 2048))
    tok = torch.full((cell.global_batch, 1), 7, dtype=torch.long, device=dev)
    torch.cuda.reset_peak_memory_stats()
    cache = T.init_cache(cfg, cell.global_batch, cell.seq_len, device=dev)
    mine = {k: v.clone() for k, v in cache.items()}
    want, plain_ms, _, _ = _counted(torch, lambda: plain(full, cache, tok))
    got, ms, _, counts = _counted(torch, lambda: prog.fn(local, mine, tok))
    equal = _bitwise(torch, got, want)
    if not equal:
        problems.append("path J: the long_500k cell != the unsharded decode")
    flops = lm_flops(cfg, 1, 1, ctx=cell.seq_len - 1)
    record = dict(
        path="J", gpu=smi, arch="qwen3-0.6b", cell=cell.name,
        layers=cfg.n_layers, batch=cell.global_batch, slots=cell.seq_len,
        cache_gib=sum(v.numel() * v.element_size()
                      for v in cache.values()) / 2**30,
        token_spec=repr(prog.in_specs[2]),
        cache_specs={k: repr(v) for k, v in prog.in_specs[1].items()},
        equal=equal, collectives=counts, max_memory_gib=peak_gib(torch),
        sharded=_decode_record(torch, lambda: prog.fn(local, mine, tok),
                               [ms], flops, 1),
        unsharded=_decode_record(torch, lambda: plain(full, cache, tok),
                                 [plain_ms], flops, 1))
    del full, local, cache, mine, got, want
    torch.cuda.empty_cache()
    return problems, record


def cells_path(mesh) -> tuple:
    """Path K: ``build_cell`` for every cell of every arch in ``ASSIGNED``
    on ``mesh`` and on a duck-typed 16 x 16 mesh (host only, meta
    tensors): ok and skipped counts; an error is a problem."""
    import types

    from repro_torch.configs import ASSIGNED, get_arch
    from repro_torch.launch.specs import SkippedCell, build_cell
    from repro_torch.tree import tree_leaves

    problems, record = [], {}
    t0 = time.perf_counter()
    duck = types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model"))
    for label, m in (("1x1", mesh), ("16x16", duck)):
        ok, skipped = 0, 0
        for arch in ASSIGNED:
            for cell in get_arch(arch).shapes:
                try:
                    prog = build_cell(arch, cell.name, m)
                except SkippedCell:
                    skipped += 1
                    continue
                except Exception as e:  # noqa: BLE001 -- a failed cell
                    problems.append(f"path K: {arch}/{cell.name} on {label}"
                                    f": {type(e).__name__}: {e}")
                    continue
                if any(x.device.type != "meta"
                       for x in tree_leaves(prog.args)):
                    problems.append(f"path K: {arch}/{cell.name} holds "
                                    "storage")
                ok += 1
        record[label] = dict(ok=ok, skipped=skipped)
    record["seconds"] = time.perf_counter() - t0
    return problems, record


def gloo_serve_run(rank, world, shape, cfg, moe, params, tokens) -> dict:
    """The prefill and 2 decodes at f32 (f32 cache): on one rank
    unsharded, else sharded on a ``shape`` mesh under the serving plan,
    gathered; logits and caches (numpy)."""
    import dataclasses

    import torch

    from repro_torch.convert import tree_from_numpy
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.tp import LMPlan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import make_moe_shardings
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    full = tree_from_numpy(params, "cpu")
    t = torch.from_numpy(tokens)
    plan, mesh = None, None
    if world > 1:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        cfg = dataclasses.replace(cfg, parallelism="tp_fsdp")
        ms = (make_moe_shardings(cfg, mesh) if moe == "ep" else
              shd.tp_expert_shardings(mesh) if moe == "tp" else None)
        plan = LMPlan(cfg, mesh, ms, batch=t.shape[0])
        full = shd.shard_tree(full, shd.lm_param_specs(cfg, mesh, full),
                              mesh)
        t = shd.shard_tree({"t": t}, {"t": shd.P(plan.batch_axes, None)},
                           mesh)["t"]
    s = t.shape[1] - 2
    kw = dict(compute_dtype=None, plan=plan)
    h, cache = T.prefill(full, t[:, :s], cfg, max_len=GLOO_SERVE_SLOTS,
                         q_chunk=8, k_chunk=8, cache_dtype=torch.float32,
                         **kw)
    out = {"prefill": T.logits_fn(full, h[:, -1:], cfg, plan)}
    for i in range(2):
        out[f"decode{i}"], cache = T.decode_step(
            full, cache, t[:, s + i:s + i + 1], cfg, **kw)
    out["cache"] = cache
    if plan is not None:
        lspec = shd.P(plan.batch_axes, None, None)
        out = shd.gather_tree(out, {"prefill": lspec, "decode0": lspec,
                                    "decode1": lspec, "cache": plan.cache},
                              mesh)
    return tree_map(lambda x: x.numpy(), out)


def gloo_serve_check(torch) -> tuple:
    """Paths G-J across ranks on the CPU: each GLOO_SERVE case on each
    of GLOO_SERVE_MESHES (4 gloo ranks, one spawn) against one process's
    unsharded passes, within GLOO_TOL."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.launch.local import run_ranks
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map

    problems, rows = [], []
    t0 = time.perf_counter()
    todo, want = [], []
    for arch, moe, kw in GLOO_SERVE:
        cfg = dataclasses.replace(get_arch(arch).smoke, **kw)
        params = tree_map(lambda v: v.numpy(), T.init_params(
            cfg, torch.Generator().manual_seed(SEED), "cpu"))
        tok = np.random.default_rng(SEED).integers(
            0, cfg.vocab, GLOO_SERVE_SHAPE).astype(np.int32)
        single = gloo_serve_run(0, 1, None, cfg, moe, params, tok)
        for shape in GLOO_SERVE_MESHES:
            todo.append(("gloo_serve_run", (shape, cfg, moe, params, tok)))
            want.append((f"{arch} {moe or 'dense'} {shape}", single))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as d:
        got = run_ranks(gloo_jobs, 4, todo, backend="gloo", store_dir=d,
                        timeout_s=GLOO_TIMEOUT_S)
    for i, (label, single) in enumerate(want):
        err, ok = 0.0, True
        for r in got:
            for a, b in zip(tree_leaves(r[i]), tree_leaves(single)):
                err = max(err, float(np.abs(a - b).max()))
                ok = ok and bool(np.allclose(a, b, **GLOO_TOL))
        if not ok:
            problems.append(f"gloo serving check {label}: a rank leaves "
                            "the single-process passes' tolerance")
        rows.append(dict(case=label, ranks=4, max_abs_err=err,
                         within_tol=ok))
    return problems, dict(device="cpu", backend="gloo", cases=rows,
                          seconds=time.perf_counter() - t0)


def serving_tp_phase(torch, smi: str, dev="cuda") -> tuple:
    """Paths G-K over one NCCL rank on a (1, 1) mesh on the card (``dev``
    "cpu": one gloo rank, for a rehearsal), then the gloo serving check
    on the CPU."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_serve_pg_")
    backend = "nccl" if dev == "cuda" else "gloo"
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}/store",
                            rank=0, world_size=1, device_id=(
                                torch.device("cuda", 0) if dev == "cuda"
                                else None))
    paths = []
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        problems, cells = cells_path(mesh)
        for name, arch, layers, variants in SERVE_PATHS:
            p, rec = serve_path(torch, mesh, smi, name, arch, layers,
                                variants, dev)
            problems += p
            paths.append(rec)
        p, rec = long_path(torch, mesh, smi, dev)
        problems += p
        paths.append(rec)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    p, gloo = gloo_serve_check(torch)
    problems += p
    return problems, dict(gpu=smi, backend=backend, world_size=1,
                          mesh=[1, 1], paths=paths, cells=cells,
                          gloo_check=gloo,
                          phase_s=time.perf_counter() - t0)


# -------------------------------------------------------- dry-run phase ----
# (a) ``python -m repro_torch.launch.dryrun --all`` on 16 x 16 (a fake
# process group of 256 ranks, host only): 36 cells ok, 4 skipped.
DRYRUN_OK, DRYRUN_SKIP = 36, 4
# (b) cells whose traced bytes must be within DRYRUN_BYTES_TOL of the
# card's (the card's branch traced); traced on the meta device as well,
# whose counts must equal the CUDA trace's (a host without a card traces
# on meta)
DRYRUN_BYTES_CELLS = ("qwen3-0.6b", "mixtral-8x7b")
DRYRUN_BYTES_TOL = 0.05
# mixtral's 16 x 16 cells as PR 25's dry-run traced them (TP experts
# holding the global capacity on every rank, the CPU's branch): per rank,
# all-reduce bytes, FLOPs, peak bytes (python -m repro_torch.launch.dryrun
# --arch mixtral-8x7b on the parent tree); the TP-expert window must cut
# the all-reduce bytes to at most a quarter, the FLOPs and peak below
DRYRUN_PR25 = {
    "mixtral-8x7b/train_4k": (2817577746520.0, 8080243673460794.0,
                              134100996372.0),
    "mixtral-8x7b/prefill_32k": (1408749273088.0, 2999279261450240.0,
                                 74339958804.0)}
# (b) cells traced on a (1, 1) mesh (a fake group of one rank) and run on
# the card over one NCCL rank, each held to its trace: (arch, cell, depth
# kept (None: all), batch (None: the cell's)); qwen3-0.6b's batch cut
# 256 -> 1 as path C's, mixtral's depth 32 -> 2 and batch 32 -> 1 as
# path H's
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", None, 1),
                ("gatedgcn", "full_graph_sm", None, None),
                ("fm", "train_batch", None, None),
                ("mixtral-8x7b", "prefill_32k", 2, 1))
DRYRUN_PEAK_TOL = 0.15          # the trace's peak against the card's
DRYRUN_BOUND_SLACK = 1.05       # t_bound may not exceed the measured time
DRYRUN_TIMEOUT_S = 600.0


def dryrun_progs(mesh) -> list:
    """[(arch, program)] of the (b) cells on ``mesh`` (``launch.specs``),
    the arch with its depth cut."""
    import dataclasses

    from repro_torch.configs.base import GNNConfig, TransformerConfig
    from repro_torch.launch import specs

    out = []
    for name, cell_name, layers, batch in DRYRUN_CELLS:
        arch = serving_arch(name, layers)
        cell = next(c for c in arch.shapes if c.name == cell_name)
        if batch:
            cell = dataclasses.replace(cell, global_batch=batch)
        build = (specs.build_lm_cell
                 if isinstance(arch.config, TransformerConfig)
                 else specs.build_gnn_cell
                 if isinstance(arch.config, GNNConfig)
                 else specs.build_fm_cell)
        out.append((arch, build(arch, cell, mesh)))
    return out


def dryrun_predict(path: str) -> None:
    """(b)'s traces: this process as the one rank of a fake group, the
    (b) cells traced on fake tensors on a (1, 1) mesh, on the card's
    device (``dryrun.card_device``: fake CUDA tensors here); the
    ``DRYRUN_BYTES_CELLS`` also on fake meta tensors (as a host without a
    card traces them); written to ``path`` as JSON. Run as a process of
    its own."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    dryrun.fake_world(1)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    progs = dryrun_progs(mesh)
    recs = [dryrun.trace(p, mesh, "1x1") for _, p in progs]
    meta = {p.arch: dryrun.trace(p, mesh, "1x1", device="meta")
            for _, p in progs if p.arch in DRYRUN_BYTES_CELLS}
    with open(path, "w") as f:
        json.dump({"traces": recs, "meta": meta}, f, default=str)


def _filled(torch, v, hi: int, gen, dev):
    """A tensor of ``v``'s shape and dtype: integers in [0, hi), True,
    or N(0, 1) floats."""
    shape = tuple(v.shape)
    if v.dtype == torch.bool:
        return torch.ones(shape, dtype=torch.bool, device=dev)
    if v.dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=dev).to(v.dtype)
    return torch.randint(0, hi, shape, generator=gen, device=dev,
                         dtype=v.dtype)


def dryrun_args(torch, arch, prog, dev) -> tuple:
    """Seeded full-size arguments of a (b) cell on ``dev`` (whole: the
    mesh has one rank)."""
    from repro_torch.configs.base import GNNConfig, TransformerConfig
    from repro_torch.data import ClickStream
    from repro_torch.models import fm as fm_m
    from repro_torch.models import gnn as gnn_m
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamW
    from repro_torch.tree import tree_map

    cfg = arch.config
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if isinstance(cfg, TransformerConfig):
        params = T.init_params(cfg, gen, device=dev)
        if prog.step_name == "prefill_step":
            return (tree_map(lambda v: v.to(torch.bfloat16), params),
                    _filled(torch, prog.args[1], cfg.vocab, gen, dev))
        tok = _filled(torch, prog.args[2]["tokens"], cfg.vocab, gen, dev)
        return (params, AdamW(lr=1e-4, weight_decay=0.01).init(params),
                {"tokens": tok, "labels": tok})
    if isinstance(cfg, GNNConfig):
        b = prog.args[2]
        n = b["node_feat"].shape[0]
        params = gnn_m.gatedgcn_init(cfg, b["node_feat"].shape[1],
                                     b["edge_feat"].shape[1], gen, dev)
        batch = {k: _filled(torch, v, n if k in ("senders", "receivers")
                            else cfg.n_classes, gen, dev)
                 for k, v in b.items()}
        return params, AdamW(lr=1e-3).init(params), batch
    params = fm_m.fm_init(cfg, gen, device=dev)
    batch = ClickStream(cfg.vocab_sizes, prog.args[2]["labels"].shape[0],
                        seed=SEED).batch_at(0)
    return (params, AdamW(lr=1e-3).init(params),
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})


def dryrun_real(torch, mesh, arch, prog, pred: dict, dev="cuda") -> tuple:
    """One (b) cell on the card: a warm-up call, one timed call (CUDA
    events around it), one call under ``OpCounter``; held to its trace
    ``pred``."""
    import gc

    from repro_torch.analysis.op_trace import OpCounter, collective_summary
    from repro_torch.distributed.sharding import shard_tree

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    full = dryrun_args(torch, arch, prog, dev)
    args = tuple(shard_tree(a, s, mesh) for a, s in zip(full, prog.in_specs))
    del full
    gc.collect()
    prog.fn(*args)
    gc.collect()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    prog.fn(*args)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    counter = OpCounter()
    counter.track(args)
    with counter:
        prog.fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    got = counter.counts()
    del args
    coll = collective_summary(got["collectives"])["by_kind"]
    rec = dict(arch=prog.arch, cell=prog.cell, measured_ms=ms,
               t_bound_ms=pred["t_bound"] * 1e3,
               bottleneck=pred["bottleneck"],
               flops=[pred["hlo_flops"], got["flops"]],
               collectives=[pred["collectives"]["by_kind"], coll],
               peak_bytes=[pred["per_device_memory"], peak],
               bytes=[pred["hlo_bytes"], got["bytes"]],
               traced_on=pred["traced_on"],
               tiles_replayed=pred["tiles_replayed"],
               plan_stand_ins=pred["plan_stand_ins"])
    problems = []
    what = f"dryrun (b) {prog.arch}/{prog.cell}"
    if pred["hlo_flops"] != got["flops"]:
        problems.append(f"{what}: FLOPs {pred['hlo_flops']} traced, "
                        f"{got['flops']} run")
    if pred["collectives"]["by_kind"] != coll:
        problems.append(f"{what}: collectives {pred['collectives']} "
                        f"traced, {coll} run")
    if (prog.arch in DRYRUN_BYTES_CELLS and abs(pred["hlo_bytes"]
                                               - got["bytes"])
            > DRYRUN_BYTES_TOL * got["bytes"]):
        problems.append(f"{what}: {pred['hlo_bytes']} bytes traced, "
                        f"{got['bytes']} run")
    if abs(pred["per_device_memory"] - peak) > DRYRUN_PEAK_TOL * peak:
        problems.append(f"{what}: peak {pred['per_device_memory']} B "
                        f"traced, {peak} B on the card")
    if pred["t_bound"] * 1e3 > DRYRUN_BOUND_SLACK * ms:
        problems.append(f"{what}: t_bound {pred['t_bound'] * 1e3:.3f} ms "
                        f"above the measured {ms:.3f} ms")
    return problems, rec


def fm_cells_equal(torch, mesh, dev="cuda") -> tuple:
    """(c): the FM cells' ``fn`` (``launch.specs.build_fm_cell`` at full
    config, rows split over the one rank) against the unsharded steps on
    the same inputs: one train step (loss, parameters, AdamW state),
    serve at FM_SERVE_BATCH, retrieval of one user against
    FM_CANDIDATES; each ``torch.equal``."""
    from repro_torch.configs import get_arch
    from repro_torch.data import ClickStream
    from repro_torch.launch import specs
    from repro_torch.models import fm as fm_m
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamW

    arch = get_arch("fm")
    cfg = arch.config
    progs = {c.kind: specs.build_fm_cell(arch, c, mesh)
             for c in arch.shapes if c.name != "serve_bulk"}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = fm_m.fm_init(cfg, gen, device=dev)
    def batch(n):
        return {k: torch.from_numpy(v).to(dev) for k, v in ClickStream(
            cfg.vocab_sizes, n, seed=SEED).batch_at(0).items()}
    tb = batch(FM_TRAIN_BATCH)
    state = AdamW(lr=1e-3).init(params)
    out = {}
    plain = steps.make_fm_train_step(cfg, AdamW(lr=1e-3))
    out["train"] = _bitwise(torch, progs["rec_train"].fn(params, state, tb),
                            plain(params, state, tb))
    del state, tb
    sb = batch(FM_SERVE_BATCH)
    out["serve"] = _bitwise(torch, progs["rec_serve"].fn(params, sb),
                            steps.make_fm_serve_step(cfg)(params, sb))
    raw = ClickStream(cfg.vocab_sizes, FM_CANDIDATES,
                      seed=SEED).batch_at(0)["idx"]
    flat = raw + fm_m.field_offsets(cfg)[None, :]
    user = torch.from_numpy(flat[0, :FM_USER_FIELDS]).to(dev)
    cand = torch.from_numpy(flat[:, FM_USER_FIELDS:]).to(dev)
    out["retrieval"] = _bitwise(
        torch, progs["rec_retrieval"].fn(params, user, cand),
        steps.make_fm_retrieval_step(cfg, FM_USER_FIELDS)(params, user,
                                                           cand))
    problems = [f"dryrun (c) fm {k}: the cell is not the unsharded step"
                for k, ok in out.items() if not ok]
    return problems, out


def _start(cmd: list, log: str):
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    f = open(log, "w")
    return subprocess.Popen(cmd, cwd=HERE, env=env, stdout=f,
                            stderr=subprocess.STDOUT), f


def _finish(proc, f, log: str, what: str) -> list:
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    f.close()
    if rc == 0:
        return []
    with open(log) as g:
        tail = g.read()[-3000:]
    return [f"dryrun {what}: exit {rc}\n{tail}"]


def dryrun_phase(torch, smi: str, dev="cuda") -> tuple:
    """(a) the dry-run of every cell on 16 x 16 and (b)'s traces, in
    processes of their own (host only, at once); then on the card over
    one NCCL rank on a (1, 1) mesh: (b) each cell against its trace, (c)
    the FM cells against the unsharded steps."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        out16, pred = (os.path.join(tmp, n) for n in ("16x16.json",
                                                      "1x1.json"))
        jobs = max(1, min(8, (os.cpu_count() or 2) - 1))
        a = _start([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--all", "--jobs", str(jobs), "--out", out16],
                   os.path.join(tmp, "a.log"))
        b = _start([sys.executable, "-c", "import chip_smoke as C; "
                    f"C.dryrun_predict({pred!r})"],
                   os.path.join(tmp, "b.log"))
        problems = _finish(*a, os.path.join(tmp, "a.log"), "(a)")
        problems += _finish(*b, os.path.join(tmp, "b.log"), "(b) trace")
        trace_s = time.perf_counter() - t0
        cells = []
        if os.path.exists(out16):
            with open(out16) as f:
                cells = json.load(f)
        preds, meta = [], {}
        if os.path.exists(pred):
            with open(pred) as f:
                traced = json.load(f)
            preds, meta = traced["traces"], traced["meta"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    status = {k: sum(r["status"] == k for r in cells)
              for k in ("ok", "skip", "error")}
    if (status["ok"], status["skip"], status["error"]) != (
            DRYRUN_OK, DRYRUN_SKIP, 0):
        problems.append(f"dryrun (a): {status}, want {DRYRUN_OK} ok, "
                        f"{DRYRUN_SKIP} skipped, 0 errors")
    a_cells = [dict(cell=f"{r['arch']}/{r['cell']}", status=r["status"],
                    bottleneck=r.get("bottleneck"), t_bound=r.get("t_bound"),
                    mfu_bound=r.get("mfu_bound"),
                    per_device_memory=r.get("per_device_memory"),
                    peak=(r.get("peak") or {}).get("flops_per_s"),
                    trace_s=r.get("compile_s"),
                    traced_on=r.get("traced_on")) for r in cells]
    moe = {}
    for r in cells:
        name = f"{r['arch']}/{r['cell']}"
        if name in DRYRUN_PR25 and r["status"] == "ok":
            now = (r["collectives"]["by_kind"].get("all-reduce", {}).get(
                "bytes", 0.0), r["hlo_flops"], r["per_device_memory"])
            moe[name] = dict(all_reduce_bytes=[DRYRUN_PR25[name][0], now[0]],
                             flops=[DRYRUN_PR25[name][1], now[1]],
                             peak_bytes=[DRYRUN_PR25[name][2], now[2]])
            if not (now[0] <= 0.25 * DRYRUN_PR25[name][0]
                    and now[1] < DRYRUN_PR25[name][1]
                    and now[2] < DRYRUN_PR25[name][2]):
                problems.append(f"dryrun (a) {name}: all-reduce bytes, "
                                f"FLOPs, peak {now} against PR 25's "
                                f"{DRYRUN_PR25[name]}")
    if set(moe) != set(DRYRUN_PR25):
        problems.append(f"dryrun (a): {sorted(moe)} of {sorted(DRYRUN_PR25)}"
                        " traced")
    meta_equal = {}
    for p in preds:
        m = meta.get(p["arch"])
        if m is None:
            continue
        keys = ("hlo_flops", "hlo_bytes", "per_device_memory")
        meta_equal[p["arch"]] = (all(m[k] == p[k] for k in keys)
                                 and m["collectives"]["by_kind"]
                                 == p["collectives"]["by_kind"])
        if not meta_equal[p["arch"]]:
            problems.append(f"dryrun (b) {p['arch']}: the meta trace "
                            f"{[m[k] for k in keys]} is not the "
                            f"{p['traced_on']} one {[p[k] for k in keys]}")
    if set(meta_equal) != set(DRYRUN_BYTES_CELLS):
        problems.append(f"dryrun (b): meta traces of {sorted(meta_equal)}")

    store = tempfile.mkdtemp(prefix="chip_smoke_dry_pg_")
    backend = "nccl" if dev == "cuda" else "gloo"
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}/store",
                            rank=0, world_size=1, device_id=(
                                torch.device("cuda", 0) if dev == "cuda"
                                else None))
    real = []
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        progs = dryrun_progs(mesh)
        if len(preds) != len(progs):
            problems.append(f"dryrun (b): {len(preds)} traces for "
                            f"{len(progs)} cells")
        for (arch, prog), p in zip(progs, preds):
            pr, rec = dryrun_real(torch, mesh, arch, prog, p, dev)
            problems += pr
            real.append(rec)
        torch.cuda.empty_cache()
        pr, fm_equal = fm_cells_equal(torch, mesh, dev)
        problems += pr
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    torch.cuda.empty_cache()
    return problems, dict(gpu=smi, mesh_a="16x16", status=status,
                          cells=a_cells, trace_s=trace_s, jobs=jobs,
                          traced_on=sorted({r["traced_on"] for r in
                                            a_cells if r["traced_on"]}),
                          mixtral_vs_pr25=moe, meta_equal=meta_equal,
                          predicted_vs_measured=real, fm_cells_equal=fm_equal,
                          phase_s=time.perf_counter() - t0)


# ----------------------------------------------------- checkpoint phase ----
CKPT_ARCH = "qwen3-0.6b"


def checkpoint_phase(torch, smi: str, dev="cuda") -> tuple:
    """A sharded checkpoint of the training state (parameters and AdamW
    moments, f32) of ``CKPT_ARCH`` at full config under "tp_fsdp" over one
    NCCL rank on a (1, 1) mesh (``dev`` "cpu": one gloo rank, for a
    rehearsal): one step from seeded parameters, ``CheckpointManager.save``
    with the specs and the mesh (global arrays, the writer async),
    ``wait``, ``restore`` into a fresh state of other values, and the
    next step from the restored state, which must be ``torch.equal`` (loss,
    parameters, AdamW state) to the next step of the run that never
    saved. The save's and the restore's seconds and the bytes written."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  lm_param_specs,
                                                  opt_state_specs, shard_tree)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.steps import make_lm_train_step
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    problems = []
    cfg = dataclasses.replace(get_arch(CKPT_ARCH).config,
                              parallelism="tp_fsdp")
    store = tempfile.mkdtemp(prefix="chip_smoke_ckpt_pg_")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    backend = "nccl" if dev == "cuda" else "gloo"
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}/store",
                            rank=0, world_size=1, device_id=(
                                torch.device("cuda", 0) if dev == "cuda"
                                else None))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        opt = AdamW(lr=TP_LR, weight_decay=0.01)
        step = make_lm_train_step(
            cfg, opt, remat=True, xent_chunk=TP_XENT,
            act_constraint=NamedSharding(mesh, tp.residual_spec(cfg, mesh)))
        stream = TokenStream(cfg.vocab, 1, TP_SEQ, seed=SEED)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                    stream.batch_at(i).items()} for i in range(2)]

        def state(seed):
            gen = torch.Generator(device=dev).manual_seed(seed)
            full = T.init_params(cfg, gen, device=dev)
            specs = lm_param_specs(cfg, mesh, full)
            params = shard_tree(full, specs, mesh)
            del full
            return params, opt.init(params), specs

        params, opt_state, specs = state(SEED)
        params, opt_state, _ = step(params, opt_state, batches[0])
        spec_tree = {"params": specs, "opt_state": opt_state_specs(specs)}
        mgr = CheckpointManager(ckpt_dir, keep=1, async_save=True)
        (_, save_s) = timed_call(torch, lambda: mgr.save(
            1, {"params": params, "opt_state": opt_state},
            spec_tree=spec_tree, mesh=mesh))
        _, commit_s = timed_call(torch, mgr.wait)
        nbytes = sum(os.path.getsize(os.path.join(root, f))
                     for root, _, files in os.walk(ckpt_dir) for f in files)
        # the run that never saved takes its next step first
        want_p, want_s, want_m = step(params, opt_state, batches[1])
        del params, opt_state
        gc.collect()
        fresh_p, fresh_s, _ = state(SEED + 1)
        (restored, manifest), restore_s = timed_call(torch, lambda: (
            mgr.restore(1, {"params": fresh_p, "opt_state": fresh_s},
                        spec_tree=spec_tree, mesh=mesh)))
        del fresh_p, fresh_s
        gc.collect()
        got_p, got_s, got_m = step(restored["params"],
                                   restored["opt_state"], batches[1])
        del restored
        equal = dict(loss=bool(torch.equal(got_m["loss"], want_m["loss"])),
                     params=_bitwise(torch, got_p, want_p),
                     opt_state=_bitwise(torch, got_s, want_s))
        n_leaves = len(tree_leaves(want_p)) + len(tree_leaves(want_s))
        loss = float(want_m["loss"])
        del got_p, got_s, want_p, want_s
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    if not all(equal.values()):
        problems.append(f"checkpoint: the step after restore differs from "
                        f"the unsaved run's: {equal}")
    if len(manifest["keys"]) != n_leaves:
        problems.append(f"checkpoint: {len(manifest['keys'])} leaves "
                        f"written, the state has {n_leaves}")
    return problems, dict(gpu=smi, arch=CKPT_ARCH, strategy="tp_fsdp",
                          backend=backend, mesh="1x1", leaves=n_leaves,
                          bytes_written=nbytes, save_s=save_s / 1e3,
                          commit_s=commit_s / 1e3, restore_s=restore_s / 1e3,
                          loss=loss, equal_to_unsaved=equal,
                          phase_s=time.perf_counter() - t0)


# --------------------------------------------------------- kernel phase ----
def kernel_cases(torch, engine, graphs, groups=None):
    """(graph, F, G, inputs, class meta) at the shapes the main path gave
    the sparse kernels: each graph's class-padded partition against B of
    width 128 (layer 1) and n_classes (layer 2), alone and stacked G=4
    (``groups``: {name: group sizes} for a graph cased otherwise)."""
    from repro_torch.core.formats import b_tiles_of, plan_to, stack_plans

    for name, g in graphs.items():
        h = engine.handle(name)
        meta = h.sclass.to_meta()
        b1 = torch.matmul(engine.prepare_x(name, g["xs"][0]), h.weights[0])
        # layer 2's B is relu(A·B1)·W2; relu(B1)·W2 has its shape and scale
        b2 = torch.matmul(torch.relu(b1), h.weights[1])
        for b in (b1, b2):
            for G in (groups or {}).get(name, (1, GROUP)):
                bt = b_tiles_of(b[None].expand(G, -1, -1),
                                meta).contiguous()
                part = [torch.stack([leaf] * G).contiguous()
                        for leaf in (h.part.dense.tiles,
                                     h.part.dense.tile_col, h.part.ell.cols,
                                     h.part.ell.vals, h.part.ell.tile_col,
                                     h.part.ell.unit_k, h.part.ell.rows)]
                plan = plan_to(stack_plans([h.host_plan] * G), bt.device)
                yield dict(graph=name, F=int(b.shape[1]), G=G), (
                    part, bt, meta, plan.dense, plan.ell, plan.ell_bucket_k)


def bsr_case(torch, case):
    """The dense engine as the main path runs it: one ``bsr_spmm_rows``
    launch, the products summed per row tile in the plan's order.

    Gates: within ``KERNEL_TOL`` of its plain version (``bsr_spmm_ref``
    then ``segment_sum``) relative to the sum of |tile|·|B| (the two add
    each 64-term dot product in another order); bit for bit equal to the
    per-tile kernel's products summed by ``segment_sum`` (the order the
    kernel keeps); the per-tile ``bsr_spmm`` within ``KERNEL_TOL`` of
    ``bsr_spmm_ref``. Library yardstick: ``torch.bmm`` on the gathered B
    tiles followed by ``segment_sum``, captured as one CUDA graph
    (``torch.bmm`` alone beside it)."""
    from repro_torch.core.formats import segment_sum
    from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_rows
    from repro_torch.kernels.ref import (_gather_b_tiles, bsr_spmm_ref,
                                         bsr_spmm_rows_ref)

    part, bt, _, plan = case[:4]
    tiles, tcol, dev = part[0], part[1], bt.device
    g, n_t, t, _ = tiles.shape
    f = bt.shape[-1]
    got = bsr_spmm_rows(tiles, tcol, bt, plan, device=dev)
    want = bsr_spmm_rows_ref(tiles, tcol, bt, plan)
    scale = bsr_spmm_rows_ref(tiles.abs(), tcol, bt.abs(), plan)
    per_tile = bsr_spmm(tiles, tcol, bt, device=dev)
    folded_bitwise = torch.equal(got, segment_sum(
        per_tile.reshape(g * n_t, t * f), plan).reshape(got.shape))
    per_tile_ok = close(per_tile, bsr_spmm_ref(tiles, tcol, bt), **KERNEL_TOL)
    ok = bool(((got - want).abs() <= KERNEL_TOL["atol"]
               + KERNEL_TOL["rtol"] * scale).all().item())
    gathered = _gather_b_tiles(bt, tcol)
    a3, b3 = tiles.reshape(g * n_t, t, t), gathered.reshape(g * n_t, t, f)

    def folded():
        return bsr_spmm_rows(tiles, tcol, bt, plan, device=dev)

    def library():
        return segment_sum(torch.bmm(a3, b3).reshape(g * n_t, t * f), plan)

    # bytes the folded function must move: the tiles the plan sums, the
    # B tiles they use, the row bands written, and the plan's indices
    order = plan.order.cpu().numpy()
    used = order.shape[0]
    used_b = len(np.unique((order // n_t) * (1 << 32)
                           + tcol.reshape(-1).cpu().numpy()[order]))
    n_rt = plan.lengths.shape[0] // g
    nbytes = (used * (t * t * 4 + 4 + 8) + used_b * t * f * 4
              + g * n_rt * t * f * 4 + (g * n_rt + 1) * 8)
    flops = 2.0 * used * t * t * f
    return dict(
        ok=ok and folded_bitwise and per_tile_ok, err=max_err(got, want),
        folded_bitwise=folded_bitwise, per_tile_ok=per_tile_ok,
        tiles_summed=used, row_tiles=n_rt,
        ms=device_ms(torch, folded), call_ms=call_ms(torch, folded),
        per_tile_ms=device_ms(torch, lambda: bsr_spmm(tiles, tcol, bt,
                                                      device=dev)),
        plain_ms=device_ms(torch, lambda: bsr_spmm_rows_ref(tiles, tcol, bt,
                                                            plan)),
        library_ms=device_ms(torch, library),
        library_bmm_ms=device_ms(torch, lambda: torch.bmm(a3, b3)),
        bound=bound(nbytes, flops))


def ell_bytes(cols, tcol, live, t, f, g, u, r, plan=None,
              bound=None, table=False) -> float:
    """Bytes an ELL function must move.

    Per unit (``plan`` None): its cols/vals lanes, tile_col, each distinct
    B row its lanes ``live`` address, and the [G, U, R, F] output.

    Folded onto rows (``plan``, the ELL ``SegmentPlan``; ``bound`` [U], the
    lanes each unit's chain reads: its band's K, ragged, or its bucket's
    K, fixed K): cols/vals of those lanes of each unit row the plan sums
    (the ragged kernel masks the values, so a masked lane inside the band
    is read too, and ``live`` is not used), tile_col and unit_k (or
    bucket_k) of their units, the plan's order, the offsets and
    live-table entries of its live rows, each distinct B row those lanes
    address, and the live output rows, read once and written once (no
    per-unit output); with ``table`` (the ragged kernel past 4 bands)
    also the band table's entry of each distinct unit index.
    """
    c = cols.cpu().numpy()
    tc = tcol.cpu().numpy()
    if plan is None:
        live = np.broadcast_to(live, cols.shape)
        gid = np.broadcast_to(np.arange(g)[:, None, None, None], cols.shape)
        rows = tc[:, :, None, None] * t + c
        used_rows = len(np.unique(gid[live] * (1 << 40) + rows[live]))
        return (cols.numel() * 8 + tcol.numel() * 4 + used_rows * f * 4
                + g * u * r * f * 4)
    kmax = c.shape[-1]
    order = plan.order.cpu().numpy()
    segs = np.flatnonzero(plan.lengths.cpu().numpy())
    unit = order // r                                 # over the group
    kb = np.asarray(bound)[unit % u]
    read = np.arange(kmax)[None, :] < kb[:, None]
    b_rows = ((unit // u)[:, None] * (1 << 40)
              + tc.reshape(-1)[unit][:, None] * t
              + c.reshape(-1, kmax)[order])[read]
    used_rows = len(np.unique(b_rows))
    used_offsets = len(np.unique(np.concatenate([segs, segs + 1])))
    return (int(kb.sum()) * 8 + len(np.unique(unit)) * 8
            + order.size * 8 + used_offsets * 8 + segs.size * 8
            + used_rows * f * 4 + 2 * segs.size * f * 4
            + (len(np.unique(unit % u)) * 4 if table else 0))


def band_bound(meta, u, kmax) -> np.ndarray:
    """[U] the K of each unit's band, as the reference's kernel selects
    it: the meta's runs merged to its default 4 bands, unit u in band
    sum(u >= off)."""
    from repro_torch.kernels.bands import (DEFAULT_MAX_BANDS, _band_tables,
                                           _bands_of)
    ks, _, offs = _band_tables(_bands_of(meta.ell_segments, u, kmax,
                                         DEFAULT_MAX_BANDS))
    return np.asarray(ks)[np.searchsorted(offs, np.arange(u),
                                          side="right")]


def trips(bound, g, r, kmax) -> dict:
    """K trips of every unit row of the group: each to Kmax, and each to
    the bound its kernel runs it to."""
    return {"kmax": int(g * len(bound) * r * kmax),
            "bounded": int(g * r * np.asarray(bound).sum())}


def rows_csr(torch, cols, vals, tcol, uk, rows, meta, nct, t):
    """The ELL entries as CSRs with int32 indices against B tiles
    [G·nct·T, F] (sentinel rows and masked lanes dropped, duplicates
    summed; built on the host, outside any timed region): one over all
    G·P padded rows, one over only the rows with an entry, and those
    rows' ids."""
    g, u, r, k = cols.shape
    p = meta.n_padded_rows
    c = cols.cpu().numpy().astype(np.int64)
    v = vals.cpu().numpy()
    rw = np.broadcast_to(rows.cpu().numpy()[..., None], c.shape)
    keep = ((np.arange(k) < uk.cpu().numpy()[:, :, None, None])
            & (rw != meta.ell_sentinel_row) & (v != 0))
    gi, ui, _, _ = np.nonzero(keep)
    tc = tcol.cpu().numpy().astype(np.int64)
    row = gi * p + rw[keep]
    col = (gi * nct + tc[gi, ui]) * t + c[keep]
    live, pos = np.unique(row, return_inverse=True)

    def csr(at, n_rows):
        m = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([at, col])), torch.from_numpy(v[keep]),
            (n_rows, g * nct * t), check_invariants=False).coalesce()
        m = m.to_sparse_csr()
        return torch.sparse_csr_tensor(
            m.crow_indices().int(), m.col_indices().int(), m.values(),
            m.shape).to(cols.device)

    return (csr(row, g * p), csr(pos, live.size),
            torch.from_numpy(live).to(cols.device))


def dense_rows(part, bt, dense_plan, p):
    """The dense engine's rows [G, P, F] (float32) as the main path makes
    them: one ``bsr_spmm_rows`` launch on the tiles in B's type, or +0
    rows and no launch for a class without dense tiles
    (``ops.dense_tiles_matmul``)."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_rows

    g, f = bt.shape[0], bt.shape[-1]
    if part[0].shape[1] == 0:
        return bt.new_zeros((g, p, f)).float()
    return bsr_spmm_rows(part[0].to(bt.dtype), part[1], bt, dense_plan,
                         device=bt.device).reshape(g, p, f)


def ell_case(torch, case):
    """The sparse engine as the main path runs it: one ``ragged_ell_rows``
    launch, each unit to its band's K (the meta's runs merged to 4 bands,
    as the main path passes them), the per-unit products summed onto the
    padded rows in plan order and added onto the dense engine's rows in
    place.

    Gates: bit for bit equal to its plain version (``ragged_ell_rows_ref``,
    the same bands), to the parent's chain (per-unit ``ragged_ell_spmm`` +
    ``scatter_ell_partials`` + ``yd + ye``) and to the Kmax pass
    (``segments=()``, the parent's function: B is finite); the per-unit
    kernel bit for bit equal to ``ragged_ell_spmm_ref``. Yardsticks: the
    parent's chain as one CUDA graph, the per-unit kernel alone, and
    ``torch.sparse.mm`` over a CSR of the ELL entries: over only the rows
    with an entry, then ``index_add_`` onto those rows (``library_ms``),
    and over all padded rows, plus the add, with the two kernels that
    take it the most device time (cuSPARSE's SpMM time grows with the
    CSR's row count, even where almost every row is empty). ``trips``:
    the K trips of the group's unit rows at Kmax and at their band's K."""
    from repro_torch.core.formats import scatter_ell_partials
    from repro_torch.kernels.ell_spmm import (contract_cost,
                                              ragged_ell_contract,
                                              ragged_ell_rows, ragged_ell_spmm)
    from repro_torch.kernels.ref import (ragged_ell_rows_ref,
                                         ragged_ell_spmm_ref)

    part, bt, meta, dense_plan, plan = case[:5]
    cols, vals, tcol, uk, rows = part[2:7]
    dev = bt.device
    g, u, r, kmax = cols.shape
    nct, t, f = bt.shape[1:]
    p = meta.n_padded_rows
    segs = tuple(meta.ell_segments)
    yd = dense_rows(part, bt, dense_plan, p)

    def per_unit():
        return ragged_ell_spmm(cols, vals, tcol, uk, bt, segments=segs,
                               device=dev)

    def chain():
        ye = scatter_ell_partials(rows.reshape(g, u * r),
                                  per_unit().reshape(g, u * r, f), meta,
                                  plan=plan)
        return yd + ye

    got = ragged_ell_rows(cols, vals, tcol, uk, bt, plan, yd.clone(),
                          segments=segs, device=dev)
    want = ragged_ell_rows_ref(cols, vals, tcol, uk, bt, plan, yd.clone(),
                               segments=segs)
    folded_bitwise = torch.equal(got, chain())
    kmax_bitwise = torch.equal(got, ragged_ell_rows(
        cols, vals, tcol, uk, bt, plan, yd.clone(), device=dev))
    per_unit_ok = torch.equal(per_unit(), ragged_ell_spmm_ref(
        cols, vals, tcol, uk, bt, segments=segs))
    buf, plain_buf, lib_buf = yd.clone(), yd.clone(), yd.clone()
    all_csr, live_csr, live_ids = rows_csr(torch, cols, vals, tcol, uk, rows,
                                           meta, nct, t)
    b2 = bt.reshape(g * nct * t, f)

    def all_rows():
        return yd + torch.sparse.mm(all_csr, b2).reshape(g, p, f)

    lengths = plan.lengths.cpu().numpy()
    entries = plan.order.shape[0]
    kb = band_bound(meta, u, kmax)
    lanes = int(kb[(plan.order.cpu().numpy() // r) % u].sum())
    live = np.broadcast_to(np.arange(kmax)[None, None, None, :]
                           < uk.cpu().numpy()[:, :, None, None], cols.shape)
    flops = 2.0 * lanes * f + entries * f + (lengths > 0).sum() * f
    cost = contract_cost(ragged_ell_contract(
        g, u, r, kmax, nct, t, f, segments=segs,
        n_slots=int(plan.live.shape[1])), cols=cols, tile_col=tcol,
        plan=plan)
    counts = dict(contract_cost=[cost["hbm_bytes"], cost["flops"]],
                  smoke=[float(ell_bytes(cols, tcol, None, t, f, g, u, r,
                                         plan=plan, bound=kb)),
                         float(flops)])
    return dict(counts=counts,
        ok=(bool(torch.equal(got, want)) and folded_bitwise and per_unit_ok
            and kmax_bitwise),
        err=max_err(got, want), folded_bitwise=folded_bitwise,
        kmax_bitwise=kmax_bitwise, per_unit_ok=per_unit_ok, entries=entries,
        live_rows=int((lengths > 0).sum()), trips=trips(kb, g, r, kmax),
        ms=device_ms(torch, lambda: ragged_ell_rows(
            cols, vals, tcol, uk, bt, plan, buf, segments=segs, device=dev)),
        call_ms=call_ms(torch, lambda: ragged_ell_rows(
            cols, vals, tcol, uk, bt, plan, buf, segments=segs, device=dev)),
        kmax_ms=device_ms(torch, lambda: ragged_ell_rows(
            cols, vals, tcol, uk, bt, plan, buf, device=dev)),
        plain_ms=device_ms(torch, lambda: ragged_ell_rows_ref(
            cols, vals, tcol, uk, bt, plan, plain_buf, segments=segs)),
        library_ms=device_ms(torch, lambda: lib_buf.view(g * p, f).index_add_(
            0, live_ids, torch.sparse.mm(live_csr, b2))),
        library_all_rows_ms=device_ms(torch, all_rows),
        library_all_rows_top=profile_calls(torch, all_rows,
                                           calls=1)["top"][:2],
        parent_chain_ms=device_ms(torch, chain),
        per_unit_ms=device_ms(torch, per_unit),
        per_unit_bound_ms=bound(ell_bytes(cols, tcol, live, t, f, g, u, r)
                                + uk.numel() * 4,
                                2.0 * int(live.sum()) * f)[0],
        bound=bound(cost["hbm_bytes"], cost["flops"]))


def fixed_ell_case(torch, case):
    """One layer's ELL rows as the "fused"/"loop" dispatches run them: one
    ``ell_spmm_rows`` launch for every bucket of the class and the group,
    each unit to its bucket's K (the plan's ``ell_bucket_k``), the unit
    rows' products summed onto the padded rows in plan order (bucket after
    bucket, each in unit order) in registers and added onto the dense
    engine's rows in place.

    Gates: one launch a call; bit for bit equal to its plain version
    (``ell_spmm_rows_ref``), to the parent's chains (the per-unit
    ``ell_spmm`` kernel per bucket, ``scatter_ell_partials`` at once
    ("fused", in the order of ``plan.ell``) or bucket by bucket into a
    running buffer ("loop"), then ``yd + ye``) and to ``ragged_ell_rows``
    (B is finite). Yardsticks: both chains as CUDA graphs, and
    ``torch.sparse.mm`` over a CSR of the ELL entries of only the rows
    with an entry, then ``index_add_`` onto those rows. ``trips``: the K
    trips of the group's unit rows at Kmax and at their bucket's K."""
    from repro_torch.core.formats import (RaggedEll, bucket_plan,
                                          ell_buckets, scatter_ell_partials)
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_spmm import (contract_cost, ell_contract,
                                              ell_spmm, ell_spmm_rows,
                                              ragged_ell_rows)
    from repro_torch.kernels.ref import ell_spmm_rows_ref

    part, bt, meta, dense_plan, plan, bucket_k = case
    cols, vals, tcol, uk, rows = part[2:7]
    dev = bt.device
    g, u, r, kmax = cols.shape
    nct, t, f = bt.shape[1:]
    p = meta.n_padded_rows
    buckets = ell_buckets(RaggedEll(cols, vals, rows, tcol, uk),
                          meta.ell_segments)
    yd = dense_rows(part, bt, dense_plan, p)

    def folded(out, rows_fn=ell_spmm_rows, **kw):
        return rows_fn(cols, vals, tcol, bt, plan, out, bucket_k, **kw)

    prod = torch.empty((g, u, r, f), dtype=torch.float32, device=dev)

    def products():
        at = 0
        for bk in buckets:
            n = bk.cols.shape[-3]
            ell_spmm(bk.cols, bk.vals, bk.tile_col, bt,
                     out=prod[:, at:at + n], device=dev)
            at += n
        return prod

    loop_plans = [bucket_plan(bk.rows.reshape(g, -1), meta, dev)
                  for bk in buckets]

    def fused_chain():
        return yd + scatter_ell_partials(rows.reshape(g, u * r),
                                         products().reshape(g, u * r, f),
                                         meta, plan=plan)

    def loop_chain():
        pr, at, parts = products(), 0, []
        for bk in buckets:
            n = bk.cols.shape[-3]
            parts.append(pr[:, at:at + n].reshape(g, n * r, f))
            at += n
        return yd + scatter_ell_partials(
            [bk.rows.reshape(g, -1) for bk in buckets], parts, meta,
            plan=loop_plans)

    c0 = ops.launch_counts()["ell_spmm"]
    got = folded(yd.clone(), device=dev)
    launches_per_call = ops.launch_counts()["ell_spmm"] - c0
    want = folded(yd.clone(), ell_spmm_rows_ref)
    fused_bitwise = torch.equal(got, fused_chain())
    loop_bitwise = torch.equal(got, loop_chain())
    ragged_bitwise = torch.equal(got, ragged_ell_rows(
        cols, vals, tcol, uk, bt, plan, yd.clone(),
        segments=tuple(meta.ell_segments), device=dev))
    _, live_csr, live_ids = rows_csr(torch, cols, vals, tcol, uk, rows,
                                     meta, nct, t)
    b2 = bt.reshape(g * nct * t, f)
    buf, plain_buf, lib_buf = yd.clone(), yd.clone(), yd.clone()
    kb = bucket_k.cpu().numpy()
    lengths = plan.lengths.cpu().numpy()
    entries = plan.order.shape[0]
    lanes = int(kb[(plan.order.cpu().numpy() // r) % u].sum())
    flops = 2.0 * lanes * f + entries * f + (lengths > 0).sum() * f
    cost = contract_cost(ell_contract(
        g, u, r, kmax, nct, t, f, segments=meta.ell_segments,
        n_slots=int(plan.live.shape[1])), cols=cols, tile_col=tcol,
        plan=plan)
    counts = dict(contract_cost=[cost["hbm_bytes"], cost["flops"]],
                  smoke=[float(ell_bytes(cols, tcol, None, t, f, g, u, r,
                                         plan=plan, bound=kb)),
                         float(flops)])
    return dict(counts=counts,
        ok=(bool(torch.equal(got, want)) and fused_bitwise and loop_bitwise
            and ragged_bitwise and launches_per_call == 1),
        err=max_err(got, want), folded_bitwise=fused_bitwise,
        loop_bitwise=loop_bitwise, ragged_bitwise=ragged_bitwise,
        launches_per_call=launches_per_call,
        bands=[[int(bk.cols.shape[-1]), int(bk.cols.shape[-3])]
               for bk in buckets],
        trips=trips(kb, g, r, kmax),
        ms=device_ms(torch, lambda: folded(buf, device=dev)),
        call_ms=call_ms(torch, lambda: folded(buf, device=dev)),
        plain_ms=device_ms(torch, lambda: folded(plain_buf,
                                                 ell_spmm_rows_ref)),
        library_ms=device_ms(torch, lambda: lib_buf.view(g * p, f).index_add_(
            0, live_ids, torch.sparse.mm(live_csr, b2))),
        parent_chain_ms=device_ms(torch, fused_chain),
        parent_loop_chain_ms=device_ms(torch, loop_chain),
        per_unit_ms=device_ms(torch, products),
        # device kernels of one call, from a profile
        kernels_per_call=profile_calls(torch, lambda: folded(
            buf, device=dev), calls=1)["kernels_per_infer"],
        parent_chain_kernels=profile_calls(
            torch, fused_chain, calls=1)["kernels_per_infer"],
        parent_loop_chain_kernels=profile_calls(
            torch, loop_chain, calls=1)["kernels_per_infer"],
        bound=bound(cost["hbm_bytes"], cost["flops"]))


# -------------------------------------------------- past four K bands ----
# The unpadded partitions reordered by labels (quickstart.prepare, as the
# training phase runs them), and the caps the table cases time: 4 (by
# value), 8 and every run ("all"), both past 4 read from the band table.
TABLE_GRAPHS = ("cora", "pubmed")
TABLE_CAPS = (("4", 4), ("8", 8), ("all", None))


def ragged_registers(build_log) -> dict:
    """Registers (lowest, highest) and spill bytes of the ragged kernel's
    instances in the four ragged sources' ptxas logs, for the by-value
    kernel and the table kernel apart."""
    from repro_torch.kernels._build import ptxas_entries

    out = {}
    for kernel in ("ell_rows_kernel", "ell_rows_table_kernel"):
        es = [e for src, entry in build_log.items()
              if src.startswith("ragged_ell_spmm")
              for e in ptxas_entries(entry["log"])
              if f"{len(kernel)}{kernel}I" in e["name"]]
        out[kernel] = dict(
            instances=len(es),
            registers=[min((e["registers"] for e in es), default=0),
                       max((e["registers"] for e in es), default=0)],
            spill_bytes=sum(e["spill_stores"] + e["spill_loads"]
                            for e in es))
    return out


def table_case(torch, name, dev="cuda"):
    """``ragged_ell_rows`` past 4 K bands on ``name``'s unpadded
    partition reordered by labels, at F = 128 (B seeded; the dense
    engine's rows to add onto): each unit to its band's K, the bands'
    Ks read from the [U] table kept on the card.

    Gates: at 8 bands and at every run, bit for bit its plain version
    (``ragged_ell_rows_ref`` at every run) and the 4-band launch (finite
    B: where a band stops a chain past ``unit_k`` adds only zeros); the
    same with bfloat16 B, bfloat16 vals, and both; each such call one
    table launch; the tables built by the first calls kept through every
    later one (the same tensors, none built again: no copy or fill at
    launch), the launches captured into the CUDA graphs of the times (a
    host sync or a pageable copy fails a capture); where a profile of
    warm calls records device events (``torch.profiler`` loses most
    traces of the ctypes-launched kernels: ``kernels_per_call`` in the
    kernel phase), one table kernel a call; the bound's bytes and
    operations by ``contract_cost`` within ``COST_TOL`` of this
    script's count. Times (device ms a call): the
    kernel at 4, 8 and every run, its plain version, the fixed-K kernel
    (one launch over the runs) and ``torch.sparse.mm`` over the live
    rows' CSR + ``index_add_``; the K trips at each cap."""
    import importlib

    from repro_torch.core.formats import b_tiles_of
    from repro_torch.examples import quickstart as qs
    from repro_torch.kernels import ops
    from repro_torch.kernels.bands import _bands_of, unit_bounds
    from repro_torch.kernels.ref import ragged_ell_rows_ref

    E = importlib.import_module("repro_torch.kernels.ell_spmm")
    data = qs.prepare(name, reorder_by="labels", seed=SEED, device=dev)
    meta, plan, part = data["meta"], data["plan"], data["part"]
    segs = tuple(meta.ell_segments)
    cols, vals, rows, tcol, uk = (x[None].contiguous() for x in part.ell)
    g, u, r, kmax = cols.shape
    nct, t, f, p = meta.n_col_tiles, meta.tile, HIDDEN, meta.n_padded_rows
    caps = {k: len(segs) if mb is None else mb for k, mb in TABLE_CAPS}
    b = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (1, meta.n_cols, f)).astype(np.float32)).to(dev)
    bt = b_tiles_of(b, meta).contiguous()
    placed = type(part)(*(type(c)(*(x[None] for x in c)) for c in part))
    yd = ops.dense_tiles_matmul(placed, b, meta, plan)
    ep = plan.ell

    def rows_at(mb, out, bb=bt, vv=vals):
        return E.ragged_ell_rows(cols, vv, tcol, uk, bb, ep, out,
                                 segments=segs, max_bands=mb, device=dev)

    def plain(out, bb=bt, vv=vals):
        return ragged_ell_rows_ref(cols, vv, tcol, uk, bb, ep, out,
                                   segments=segs, max_bands=len(segs))

    types = {"float32": (vals, bt), "f32_bf16": (vals, bt.bfloat16()),
             "bf16_bf16": (vals.bfloat16(), bt.bfloat16()),
             "bf16_f32": (vals.bfloat16(), bt)}
    bitwise, per_call = {}, []
    for pair, (vv, bb) in types.items():
        want = plain(yd.clone(), bb, vv)
        four = torch.equal(rows_at(4, yd.clone(), bb, vv), want)
        ok = four
        for key in ("8", "all"):
            before = sum(E.table_launches.values())
            ok = ok and torch.equal(rows_at(caps[key], yd.clone(), bb, vv),
                                    want)
            per_call.append(sum(E.table_launches.values()) - before)
        bitwise[pair] = ok
    band_plans = {k: _bands_of(segs, u, kmax, mb) for k, mb in caps.items()}
    trip = {k: trips(unit_bounds(bp), g, r, kmax)["bounded"]
            for k, bp in band_plans.items()}
    tables = {k: E.band_table(bp, dev) for k, bp in band_plans.items()
              if len(bp) > E.VALUE_BANDS}
    n_tables = len(E._tables)
    buf, plain_buf, lib_buf = yd.clone(), yd.clone(), yd.clone()
    prof = profile_calls(torch, lambda: rows_at(caps["all"], buf), calls=5,
                         detail=True)
    # None: the trace recorded no device event (a lost trace)
    one_kernel = (None if not prof["kernels_per_infer"] else
                  prof["kernels_per_infer"] == 1 and all(
                      "ell_rows_table_kernel" in k
                      for k in prof["per_kernel"]))
    _, live_csr, live_ids = rows_csr(torch, cols, vals, tcol, uk, rows,
                                     meta, nct, t)
    b2 = bt.reshape(g * nct * t, f)
    all_bound = unit_bounds(band_plans["all"])
    lengths = plan.ell.lengths.cpu().numpy()
    lanes = int(all_bound[(ep.order.cpu().numpy() // r) % u].sum())
    flops = 2.0 * lanes * f + ep.order.shape[0] * f + (lengths > 0).sum() * f
    cost = E.contract_cost(E.ragged_ell_contract(
        g, u, r, kmax, nct, t, f, segments=segs, max_bands=caps["all"],
        n_slots=int(ep.live.shape[1])), cols=cols, tile_col=tcol, plan=ep)
    smoke = [float(ell_bytes(cols, tcol, None, t, f, g, u, r, plan=ep,
                             bound=all_bound, table=True)), float(flops)]
    counts_ok = (abs(cost["hbm_bytes"] - smoke[0]) <= COST_TOL * smoke[0]
                 and abs(cost["flops"] - smoke[1]) <= COST_TOL * smoke[1])
    ms = {k: device_ms(torch, lambda mb=mb: rows_at(mb, buf))
          for k, mb in caps.items()}
    kept = len(E._tables) == n_tables and all(
        E.band_table(band_plans[k], dev) is t for k, t in tables.items())
    return dict(
        graph=f"{name}@labels (unpadded)", F=f, G=g, units=u, runs=len(segs),
        bands={k: len(bp) for k, bp in band_plans.items()},
        trips=dict(trip, kmax=g * u * r * kmax), ms=ms,
        plain_ms=device_ms(torch, lambda: plain(plain_buf)),
        fixed_k_ms=device_ms(torch, lambda: E.ell_spmm_rows(
            cols, vals, tcol, bt, ep, buf, plan.ell_bucket_k, device=dev)),
        library_ms=device_ms(torch, lambda: lib_buf.view(g * p, f).index_add_(
            0, live_ids, torch.sparse.mm(live_csr, b2))),
        bound=bound(cost["hbm_bytes"], cost["flops"]),
        counts=dict(contract_cost=[cost["hbm_bytes"], cost["flops"]],
                    smoke=smoke),
        bitwise=bitwise, table_launches_per_call=per_call,
        tables_kept=kept, one_kernel_a_call=one_kernel,
        profile_top=prof["top"][:2],
        ok=(all(bitwise.values()) and set(per_call) == {1} and kept
            and one_kernel is not False and counts_ok))


def table_phase(torch, build_log, dev="cuda") -> tuple:
    """``table_case`` on the labels-reordered cora and pubmed, and the
    ragged kernel's registers (``ragged_registers``: no instance of
    either kernel may spill). Returns (problems, records)."""
    problems, records = [], []
    regs = ragged_registers(build_log)
    for kernel, rec in regs.items():
        print(f"  ragged {kernel}: {rec['instances']} instances, "
              f"{rec['registers'][0]}-{rec['registers'][1]} registers, "
              f"{rec['spill_bytes']} spill bytes")
        if rec["spill_bytes"] or not rec["instances"]:
            problems.append(f"ragged {kernel}: {rec}")
    for name in TABLE_GRAPHS:
        res = table_case(torch, name, dev)
        ms = res["ms"]
        print(f"  ragged_ell_rows past 4 bands, {res['graph']} ({res['runs']}"
              f" runs, {res['units']} units) F={res['F']}: max_bands 4 "
              f"{ms['4']:.5f} ms, 8 {ms['8']:.5f} ms, all "
              f"{ms['all']:.5f} ms; fixed-K {res['fixed_k_ms']:.5f} ms; "
              f"library {res['library_ms']:.5f} ms; plain "
              f"{res['plain_ms']:.4f} ms; bound {res['bound'][0]:.5f} ms "
              f"({res['bound'][1]}); K trips {json.dumps(res['trips'])}; "
              f"bitwise {json.dumps(res['bitwise'])}; tables kept "
              f"{res['tables_kept']}; one kernel a call "
              f"{res['one_kernel_a_call']} (None: the trace was lost)")
        if not res["ok"]:
            why = {k: res[k] for k in ("bitwise", "table_launches_per_call",
                                       "tables_kept", "one_kernel_a_call",
                                       "counts", "profile_top")}
            problems.append(f"ragged_ell_rows past 4 bands at "
                            f"{res['graph']}: {json.dumps(why)}")
        records.append(res)
    return problems, dict(registers=regs, cases=records)


def matmul_case(torch, case):
    """``tile_matmul`` at the configuration the wrapper picks, held against
    ``torch.matmul``; every configuration is timed and must give the
    picked one's bits."""
    from repro_torch.kernels.ref import tile_matmul_ref
    from repro_torch.kernels.tile_matmul import CONFIGS, tile_matmul

    a, b = case
    got = tile_matmul(a, b, device=a.device)
    want = tile_matmul_ref(a, b)
    m, k = a.shape
    n = b.shape[1]
    configs_bitwise = all(torch.equal(tile_matmul(a, b, config=c,
                                                      device=a.device), got)
                          for c in CONFIGS)
    config_ms = {c: device_ms(torch, lambda c=c: tile_matmul(
                     a, b, config=c, device=a.device))
                 for c in CONFIGS}
    return dict(
        ok=matmul_close(torch, got, want, a, b) and configs_bitwise,
        err=max_err(got, want), configs_bitwise=configs_bitwise,
        config_ms=config_ms,
        ms=device_ms(torch, lambda: tile_matmul(a, b, device=a.device)),
        call_ms=call_ms(torch, lambda: tile_matmul(a, b, device=a.device)),
        plain_ms=device_ms(torch, lambda: tile_matmul_ref(a, b)),
        library_ms=device_ms(torch, lambda: torch.matmul(a, b)),
        bound=bound(4.0 * (m * k + k * n + m * n), 2.0 * m * k * n))


# ------------------------------------------------------------ bfloat16 ----
BF16_DISPATCHES = ("ragged", "fused", "loop")


def bf16_close(torch, got, want, mag, rounded=None) -> bool:
    """``|got - want| <= ulp_bf16(|want|) + 2e-6 * mag`` (``mag`` = |A| @
    |B|), plus ``ulp_bf16(rounded)`` where a partial result of that
    magnitude is rounded to bfloat16 on the way (``ref.bf16_tolerance``)."""
    from repro_torch.kernels.ref import bf16_tolerance

    return bool(((got.double() - want.double()).abs()
                 <= bf16_tolerance(want, mag, rounded=rounded)).all().item())


def abs_partition(part):
    """A partition with the absolute values of its entries: the hybrid
    product of it with |B| is |A| @ |B|."""
    return part._replace(
        dense=part.dense._replace(tiles=part.dense.tiles.abs()),
        ell=part.ell._replace(vals=part.ell.vals.abs()),
        coo=part.coo._replace(vals=part.coo.vals.abs()))


def bf16_phase(torch, engine, graphs) -> tuple:
    """The paper's GCN (2 layers, hidden 128: each graph's registered
    weights) in bfloat16 on cora, citeseer and pubmed through
    ``gcn_forward(backend="cuda")`` over the engine's class-padded
    partitions and plans. For each ELL dispatch the launch counters are
    set to 0 just before one ``gcn_forward`` over the three graphs and
    read just after; layer 1's X·W runs through ``ops.matmul``
    (``tile_matmul``, which ``gcn_forward`` does not call: its X·W is
    ``torch.matmul``, as the reference's ``x @ w``) in a window of its
    own. The repeat and the per-layer checks run after those windows.

    Gates: logits bfloat16, finite, of the class's shape; bitwise equal
    across "ragged" / "fused" / "loop" and a repeat; each layer's
    aggregation (on the same B) within ``bf16_close`` of the "torch"
    backend on the card, with the dense rows' rounding (``rounded``) as
    the reference rounds them; ``gcn_forward`` bitwise the composition of
    its layers; X·W within ``bf16_close`` of its plain version; in each
    window the bfloat16 instances of the kernels it runs launched, and no
    float32 one. Returns (problems, records, the bfloat16 launches by
    kernel: the "ragged" window's for ragged_ell_spmm and bsr_spmm,
    {"fused", "loop"} for ell_spmm, the ``ops.matmul`` window's for
    tile_matmul; each window's counts by type)."""
    from repro_torch.core import gcn_forward, gcn_layer, hybrid_spmm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import tile_matmul_ref

    bf16 = torch.bfloat16
    problems, records = [], []
    inputs = {}
    for name, g in graphs.items():
        h = engine.handle(name)
        kw = dict(meta=h.sclass.to_meta(), plan=h.plan, device=engine.device)
        inputs[name] = (h, kw, engine.prepare_x(name, g["xs"][0]).to(bf16),
                        [w.to(bf16) for w in h.weights])
    torch.cuda.synchronize()
    outs, windows = {}, {}
    for d in BF16_DISPATCHES:
        ops.reset_launch_counts()
        outs[d] = {name: gcn_forward(h.part, x, ws, ell_dispatch=d, **kw)
                   for name, (h, kw, x, ws) in inputs.items()}
        torch.cuda.synchronize()
        windows[d] = ops.launch_counts_by_dtype()
    ops.reset_launch_counts()
    xws = {name: ops.matmul(x, ws[0])
           for name, (h, kw, x, ws) in inputs.items()}
    torch.cuda.synchronize()
    windows["ops.matmul"] = ops.launch_counts_by_dtype()
    for name, (h, kw, x, ws) in inputs.items():
        y = outs["ragged"][name]
        again = gcn_forward(h.part, x, ws, **kw)
        plain = gcn_forward(h.part, x, ws, backend="torch", **kw)
        xw = xws[name]
        torch.cuda.synchronize()
        rec = dict(graph=name, shape=list(y.shape), dtype=str(y.dtype),
                   finite=bool(torch.isfinite(y).all().item()),
                   dispatches_bitwise=all(torch.equal(o[name], y)
                                          for o in outs.values()),
                   repeat_bitwise=torch.equal(again, y),
                   e2e_max_abs_err_vs_torch=max_err(y.float(), plain.float()),
                   e2e_elements_differing=int((y != plain).sum().item()),
                   elements=y.numel())
        # each layer against the plain backend, on the same input
        hin, layers, ok_layers = x, [], True
        for i, w in enumerate(ws):
            got = gcn_layer(h.part, hin, w, **kw)
            want = gcn_layer(h.part, hin, w, backend="torch", **kw)
            b = torch.matmul(hin, w)
            mag = hybrid_spmm(abs_partition(h.part), b.abs().float(),
                              backend="torch", **kw)
            ok = (got.dtype == bf16
                  and bf16_close(torch, got, want, mag, rounded=mag))
            ok_layers &= ok
            layers.append(dict(layer=i + 1, within_bound=ok,
                               max_abs_err=max_err(got.float(),
                                                   want.float()),
                               differing=int((got != want).sum().item())))
            hin = torch.relu(got) if i < len(ws) - 1 else got
        rec.update(layers=layers, composed_bitwise=torch.equal(hin, y))
        mag = torch.matmul(x.abs().float(), ws[0].abs().float())
        rec["xw"] = dict(shape=[*x.shape, ws[0].shape[1]],
                         dtype=str(xw.dtype),
                         within_bound=(xw.dtype == bf16 and bf16_close(
                             torch, xw, tile_matmul_ref(x, ws[0]), mag)))
        records.append(rec)
        if not (rec["finite"] and y.dtype == bf16 and ok_layers
                and rec["dispatches_bitwise"] and rec["repeat_bitwise"]
                and rec["composed_bitwise"] and rec["xw"]["within_bound"]):
            problems.append(f"bf16 GCN {name}: {rec}")
    runs = {"ragged": ("ragged_ell_spmm", "bsr_spmm", "coo_rows"),
            "fused": ("ell_spmm", "bsr_spmm", "coo_rows"),
            "loop": ("ell_spmm", "bsr_spmm", "coo_rows"),
            "ops.matmul": ("tile_matmul",)}
    for w, kernels in runs.items():
        counts = windows[w]
        if (any(counts[k]["bfloat16"] == 0 for k in kernels)
                or any(c["float32"] for c in counts.values())):
            problems.append(f"bf16 path, {w}: not every bfloat16 instance "
                            f"of {kernels} launched, or a float32 one did "
                            f"({counts})")
    launches = {
        "ragged_ell_spmm": windows["ragged"]["ragged_ell_spmm"]["bfloat16"],
        "bsr_spmm": windows["ragged"]["bsr_spmm"]["bfloat16"],
        "ell_spmm": {d: windows[d]["ell_spmm"]["bfloat16"]
                     for d in ("fused", "loop")},
        "tile_matmul": windows["ops.matmul"]["tile_matmul"]["bfloat16"]}
    return problems, records, launches, windows


def bf16_bsr_case(torch, case, case4):
    """The dense engine at bfloat16 (tiles cast to B's type, as the main
    path's ``ops.dense_tiles_matmul``): the tensor-core rows kernel
    within ``bf16_close`` of its plain version, bitwise across repeats,
    equal to the per-tile kernel's products summed by ``segment_sum`` and
    rounded, and the same bits for each member of ``case4`` (the G = 4
    stack of ``case``). Library: ``torch.bmm(..., out_dtype=float32)`` on
    the gathered B tiles, ``segment_sum`` and the rounding."""
    from repro_torch.core.formats import segment_sum
    from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_rows
    from repro_torch.kernels.ref import _gather_b_tiles, bsr_spmm_rows_ref

    bf16 = torch.bfloat16
    part, bt, _, plan = case[:4]
    tiles, tcol, dev = part[0].to(bf16), part[1], bt.device
    b16 = bt.to(bf16)
    g, n_t, t, _ = tiles.shape
    f = bt.shape[-1]
    got = bsr_spmm_rows(tiles, tcol, b16, plan, device=dev)
    want = bsr_spmm_rows_ref(tiles, tcol, b16, plan)
    mag = bsr_spmm_rows_ref(tiles.abs().float(), tcol, b16.abs().float(),
                            plan)
    repeat = torch.equal(bsr_spmm_rows(tiles, tcol, b16, plan, device=dev),
                         got)
    per_tile = bsr_spmm(tiles, tcol, b16, device=dev)
    folded = torch.equal(got, segment_sum(
        per_tile.reshape(g * n_t, t * f), plan).reshape(got.shape).to(
            bf16).float())
    part4, bt4, _, plan4 = case4[:4]
    got4 = bsr_spmm_rows(part4[0].to(bf16), part4[1], bt4.to(bf16), plan4,
                         device=dev)
    mates = all(torch.equal(got4[i], got[0]) for i in range(got4.shape[0]))
    a3 = tiles.reshape(g * n_t, t, t)
    b3 = _gather_b_tiles(b16, tcol).reshape(g * n_t, t, f)

    def library():
        return segment_sum(torch.bmm(a3, b3, out_dtype=torch.float32)
                           .reshape(g * n_t, t * f), plan).to(bf16).float()

    order = plan.order.cpu().numpy()
    used = order.shape[0]
    used_b = len(np.unique((order // n_t) * (1 << 32)
                           + tcol.reshape(-1).cpu().numpy()[order]))
    n_rt = plan.lengths.shape[0] // g
    nbytes = (used * (t * t * 2 + 4 + 8) + used_b * t * f * 2
              + g * n_rt * t * f * 4 + (g * n_rt + 1) * 8)
    return dict(
        ok=bf16_close(torch, got, want, mag) and repeat and folded and mates,
        err=max_err(got, want), repeat_bitwise=repeat, folded_bitwise=folded,
        group_bitwise=mates,
        ms=device_ms(torch, lambda: bsr_spmm_rows(tiles, tcol, b16, plan,
                                                  device=dev)),
        call_ms=call_ms(torch, lambda: bsr_spmm_rows(tiles, tcol, b16, plan,
                                                     device=dev)),
        plain_ms=device_ms(torch, lambda: bsr_spmm_rows_ref(tiles, tcol, b16,
                                                            plan)),
        library_ms=device_ms(torch, library),
        bound=bound(nbytes, 2.0 * used * t * t * f, BF16_FLOPS_PER_S))


def bf16_ell_case(torch, case):
    """The ragged ELL rows at bfloat16 B (the partition's float32 vals, as
    the main path's bfloat16 GCN gives them), onto the bfloat16 dense
    engine's rows, each unit to its band's K: for every launch shape the
    kernel is built with, bitwise the float32 instance on ``b.float()``,
    and bitwise its plain version; the per-unit kernel likewise. Library:
    ``torch.sparse.mm`` over the live rows' CSR on B upcast to float32,
    then ``index_add_``."""
    from repro_torch.kernels.autotune import candidates
    from repro_torch.kernels.ell_spmm import (contract_cost,
                                              ragged_ell_contract,
                                              ragged_ell_rows, ragged_ell_spmm)
    from repro_torch.kernels.ref import ragged_ell_rows_ref

    bf16 = torch.bfloat16
    part, bt, meta, dense_plan, plan = case[:5]
    cols, vals, tcol, uk, rows = part[2:7]
    dev = bt.device
    g, u, r, kmax = cols.shape
    nct, t, f = bt.shape[1:]
    p = meta.n_padded_rows
    segs = tuple(meta.ell_segments)
    b16 = bt.to(bf16)
    b32 = b16.float()
    yd = dense_rows(part, b16, dense_plan, p)
    tunes = candidates(f)

    def rows_of(b, out, **kw):
        return ragged_ell_rows(cols, vals, tcol, uk, b, plan, out,
                               segments=segs, device=dev, **kw)

    equal = all(torch.equal(rows_of(b16, yd.clone(), tune=tn),
                            rows_of(b32, yd.clone(), tune=tn))
                for tn in tunes)
    got = rows_of(b16, yd.clone())
    want = ragged_ell_rows_ref(cols, vals, tcol, uk, b16, plan, yd.clone(),
                               segments=segs)
    per_unit = torch.equal(
        ragged_ell_spmm(cols, vals, tcol, uk, b16, segments=segs,
                        device=dev),
        ragged_ell_spmm(cols, vals, tcol, uk, b32, segments=segs,
                        device=dev))
    _, live_csr, live_ids = rows_csr(torch, cols, vals, tcol, uk, rows,
                                     meta, nct, t)
    b2 = b16.reshape(g * nct * t, f)
    buf, plain_buf, lib_buf = yd.clone(), yd.clone(), yd.clone()
    cost = contract_cost(ragged_ell_contract(
        g, u, r, kmax, nct, t, f, segments=segs,
        n_slots=int(plan.live.shape[1]), b_dtype=bf16), cols=cols,
        tile_col=tcol, plan=plan)
    return dict(
        ok=equal and per_unit and torch.equal(got, want),
        err=max_err(got, want), shapes_bitwise_f32=equal,
        launch_shapes=len(tunes), per_unit_bitwise_f32=per_unit,
        ms=device_ms(torch, lambda: rows_of(b16, buf)),
        call_ms=call_ms(torch, lambda: rows_of(b16, buf)),
        plain_ms=device_ms(torch, lambda: ragged_ell_rows_ref(
            cols, vals, tcol, uk, b16, plan, plain_buf, segments=segs)),
        library_ms=device_ms(torch, lambda: lib_buf.view(g * p, f).index_add_(
            0, live_ids, torch.sparse.mm(live_csr, b2.float()))),
        bound=bound(cost["hbm_bytes"], cost["flops"]))


def bf16_fixed_ell_case(torch, case):
    """The fixed-K rows at bfloat16 B, every bucket in one launch onto the
    bfloat16 dense engine's rows: bitwise the float32 instance on
    ``b.float()`` and bitwise the plain version. Library as for the
    ragged kernel."""
    from repro_torch.kernels.ell_spmm import (contract_cost, ell_contract,
                                              ell_spmm_rows)
    from repro_torch.kernels.ref import ell_spmm_rows_ref

    bf16 = torch.bfloat16
    part, bt, meta, dense_plan, plan, bucket_k = case
    cols, vals, tcol, uk, rows = part[2:7]
    dev = bt.device
    g, u, r, kmax = cols.shape
    nct, t, f = bt.shape[1:]
    p = meta.n_padded_rows
    b16 = bt.to(bf16)
    yd = dense_rows(part, b16, dense_plan, p)

    def folded(out, b, rows_fn=ell_spmm_rows, **kw):
        return rows_fn(cols, vals, tcol, b, plan, out, bucket_k, **kw)

    got = folded(yd.clone(), b16, device=dev)
    equal = torch.equal(got, folded(yd.clone(), b16.float(), device=dev))
    want = folded(yd.clone(), b16, ell_spmm_rows_ref)
    _, live_csr, live_ids = rows_csr(torch, cols, vals, tcol, uk, rows,
                                     meta, nct, t)
    b2 = b16.reshape(g * nct * t, f)
    buf, plain_buf, lib_buf = yd.clone(), yd.clone(), yd.clone()
    cost = contract_cost(ell_contract(
        g, u, r, kmax, nct, t, f, segments=meta.ell_segments,
        n_slots=int(plan.live.shape[1]), b_dtype=bf16), cols=cols,
        tile_col=tcol, plan=plan)
    return dict(
        ok=equal and torch.equal(got, want), err=max_err(got, want),
        bitwise_f32=equal, bands=len(meta.ell_segments),
        ms=device_ms(torch, lambda: folded(buf, b16, device=dev)),
        call_ms=call_ms(torch, lambda: folded(buf, b16, device=dev)),
        plain_ms=device_ms(torch, lambda: folded(plain_buf, b16,
                                                 ell_spmm_rows_ref)),
        library_ms=device_ms(torch, lambda: lib_buf.view(g * p, f).index_add_(
            0, live_ids, torch.sparse.mm(live_csr, b2.float()))),
        bound=bound(cost["hbm_bytes"], cost["flops"]))


def bf16_matmul_case(torch, a, b):
    """``tile_matmul`` at bfloat16 (the wgmma instances, C rounded once)
    within ``bf16_close`` of its plain version; every configuration timed
    and bitwise the picked one, and a repeat bitwise. Library:
    ``torch.matmul`` on bfloat16. ``bound_share``: the bound over the
    kernel's time."""
    from repro_torch.kernels.ref import tile_matmul_ref
    from repro_torch.kernels.tile_matmul import (CONFIGS, matmul_contract,
                                                 tile_matmul)

    bf16 = torch.bfloat16
    a, b = a.to(bf16).contiguous(), b.to(bf16).contiguous()
    m, k = a.shape
    n = b.shape[1]
    got = tile_matmul(a, b, device=a.device)
    want = tile_matmul_ref(a, b)
    mag = torch.matmul(a.abs().float(), b.abs().float())
    configs = all(torch.equal(tile_matmul(a, b, config=c, device=a.device),
                              got) for c in CONFIGS)
    ms = device_ms(torch, lambda: tile_matmul(a, b, device=a.device))
    bnd = bound(2.0 * (m * k + k * n + m * n), 2.0 * m * k * n,
                BF16_FLOPS_PER_S)
    contract = matmul_contract(
        m, k, n, dtype=bf16, n_sms=torch.cuda.get_device_properties(
            a.device).multi_processor_count)
    return dict(
        ok=got.dtype == bf16 and bf16_close(torch, got, want, mag)
        and configs and torch.equal(tile_matmul(a, b, device=a.device), got),
        err=max_err(got.float(), want.float()), configs_bitwise=configs,
        config=contract["config"], grid=list(contract["grid"]),
        config_ms={c: device_ms(torch, lambda c=c: tile_matmul(
            a, b, config=c, device=a.device)) for c in CONFIGS},
        ms=ms, bound_share=bnd[0] / ms,
        call_ms=call_ms(torch, lambda: tile_matmul(a, b, device=a.device)),
        plain_ms=device_ms(torch, lambda: tile_matmul_ref(a, b)),
        library_ms=device_ms(torch, lambda: torch.matmul(a, b)),
        bound=bnd)


# name, source of the bfloat16 instances, the float32 kernel's entry name,
# and which of a source's ptxas lines are bfloat16 instances
BF16_KERNELS = (
    ("ragged_ell_spmm",
     "src/repro_torch/kernels/csrc/ragged_ell_spmm_f32_bf16.cu", ""),
    ("bsr_spmm", "src/repro_torch/kernels/csrc/bsr_spmm.cu", "mma_kernel"),
    ("ell_spmm", "src/repro_torch/kernels/csrc/ell_spmm.cu",
     "13__nv_bfloat16"),
    ("tile_matmul", "src/repro_torch/kernels/csrc/tile_matmul.cu",
     "wgmma_matmul_kernel"),
)


def bf16_kernel_entries(torch, engine, graphs, launches, build_log) -> tuple:
    """The four kernels' bfloat16 instances at PERF.md §6's shapes: the
    cora class at F = 128 (and 7, the output width), G = 1 (the dense
    engine also G = 4), ``tile_matmul`` at every graph's layer 1 and
    layer 2 (B = relu(X·W1) in bfloat16). ``launches``: the bfloat16
    path's launches by kernel (``bf16_phase``). A spill of a wgmma
    ``tile_matmul`` instance fails. Returns (problems, one {"kernels"}
    entry per kernel)."""
    from repro_torch.kernels._build import ptxas_entries

    problems, entries = [], []
    cases = {(lab["F"], lab["G"]): case
             for lab, case in kernel_cases(torch, engine,
                                           {"cora": graphs["cora"]})}
    rows = {k: [] for k, _, _ in BF16_KERNELS}
    for f in sorted({f for f, _ in cases}, reverse=True):
        label = dict(graph="cora", F=f, G=1, dtype="bfloat16")
        rows["bsr_spmm"].append((label, bf16_bsr_case(
            torch, cases[(f, 1)], cases[(f, GROUP)])))
        rows["ragged_ell_spmm"].append((label, bf16_ell_case(
            torch, cases[(f, 1)])))
        rows["ell_spmm"].append((label, bf16_fixed_ell_case(
            torch, cases[(f, 1)])))
    for name in GRAPHS:
        h = engine.handle(name)
        a = engine.prepare_x(name, graphs[name]["xs"][0])
        ws = [w.to(torch.bfloat16) for w in h.weights]
        a2 = torch.relu(torch.matmul(a.to(torch.bfloat16), ws[0]))
        for layer, x, w in ((1, a, ws[0]), (2, a2, ws[1])):
            rows["tile_matmul"].append((dict(
                graph=name, layer=layer, shape=[*x.shape, w.shape[1]],
                dtype="bfloat16"), bf16_matmul_case(torch, x, w)))
    for kname, source, mark in BF16_KERNELS:
        rs = []
        for label, res in rows[kname]:
            row = dict(label, ms=res["ms"], call_ms=res["call_ms"],
                       plain_ms=res["plain_ms"], library_ms=res["library_ms"],
                       bound_ms=res["bound"][0], bound_by=res["bound"][1],
                       max_abs_err=res["err"],
                       **{k: v for k, v in res.items() if k not in (
                           "ms", "call_ms", "plain_ms", "library_ms",
                           "bound", "err", "ok")})
            rs.append(row)
            print(f"  {kname + ' bf16':16s} {json.dumps(label):52s} kernel "
                  f"{res['ms']:.4f} ms (call {res['call_ms']:.4f})  plain "
                  f"{res['plain_ms']:.4f} ms  library "
                  f"{res['library_ms']:.4f} ms  bound "
                  f"{res['bound'][0]:.5f} ms ({res['bound'][1]})  "
                  f"max_abs_err {res['err']:.3g}")
            if "bound_share" in res:
                print(f"    picked {res['config']} {res['grid']}, "
                      f"{res['bound_share']:.3f} of the bound; configs "
                      + json.dumps(res["config_ms"])
                      + f" bitwise {res['configs_bitwise']}")
            if not res["ok"]:
                problems.append(f"{kname} bf16 {label}: disagrees ({row})")
        head = rs[0]
        log = build_log[os.path.basename(source)[:-3]]["log"]
        if kname == "tile_matmul":
            for e in ptxas_entries(log):
                if mark not in e["name"]:
                    continue
                print(f"    ptxas {e['name']}: {e['registers']} registers, "
                      f"{e['smem']} bytes static smem, spills "
                      f"{e['spill_stores']} / {e['spill_loads']} bytes")
                if e["spill_stores"] or e["spill_loads"]:
                    problems.append(f"tile_matmul bf16 instance {e['name']}"
                                    f" spills ({e})")
        n, by_path = launches[kname], {}
        if isinstance(n, dict):     # ell_spmm: {"fused": .., "loop": ..}
            by_path, n = dict(launches_by_path=n), next(iter(n.values()))
        elif kname == "tile_matmul":
            by_path = dict(launches_from="ops.matmul")
        entries.append(dict(
            name=f"{kname}_bf16", route="cuda", source=source,
            replaces=dict((k, r) for k, _, r, _, _ in KERNELS)[kname],
            launches=n, **by_path, max_abs_err=max(
                r["max_abs_err"] for r in rs),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            shape=", ".join(f"{k}={v}" for k, v in head.items()
                            if k in ("graph", "F", "G", "layer", "shape")),
            ptxas=[ln for ln in ptxas_summary(log) if mark in ln],
            cases=rs))
    return problems, entries


# ------------------------------------------------------------ COO kernel ----
# Synthetic COO leaves shaped like the COO engine's share of the
# Reddit- and Flickr-sized GCN graphs (registered with the labels
# reorder): output rows, rows with entries, entries, entries after class
# padding, the longest rows, the entries in rows of at least
# ``COO_TAIL`` entries, and the two layers' widths (hidden, classes).
# Short rows are geometric (a median of 6 and a p99 of 40 Reddit-like,
# against the graph's 7 and 46; 2 and 8 Flickr-like, against 2 and 11);
# columns are uniform over the graph, so gathered B rows hit the L2 less
# often than on a label-ordered graph.
COO_TAIL = 256
COO_SHAPES = {
    "reddit-like": dict(rows=233_024, live=232_609, entries=2_176_039,
                        padded=2_720_256, tail=193_000, widths=(128, 41),
                        longest=(11_308, 8_213, 6_474, 5_472, 4_814)),
    "flickr-like": dict(rows=89_280, live=62_222, entries=137_982,
                        padded=172_544, tail=2_717, widths=(128, 7),
                        longest=(740,)),
}
# The long-row lengths the COO cases time besides the kernel's own.
COO_LONG_ROWS = (64, 512, 2048)


def coo_leaves(torch, h, g: int) -> tuple:
    """A registered graph's class-padded COO leaves and its plan, stacked
    ``g`` times, on the card: (cols, vals, plan)."""
    from repro_torch.core.formats import plan_to, stack_plans

    cols, vals = (torch.stack([x] * g).contiguous()
                  for x in (h.part.coo.cols, h.part.coo.vals))
    return cols, vals, plan_to(stack_plans([h.host_plan] * g), cols.device)


def coo_cases(torch, engine, graphs):
    """(label, case) at the main path's COO shapes: each graph's
    class-padded COO against B of width 128 (layer 1) and n_classes
    (layer 2), alone and stacked G = 4; case = (cols, vals, b_tiles,
    plan, padded rows)."""
    from repro_torch.core.formats import b_tiles_of

    for name, g in graphs.items():
        h = engine.handle(name)
        if not h.sclass.coo_nnz:
            continue
        meta = h.sclass.to_meta()
        b1 = torch.matmul(engine.prepare_x(name, g["xs"][0]), h.weights[0])
        b2 = torch.matmul(torch.relu(b1), h.weights[1])
        for b in (b1, b2):
            for G in (1, GROUP):
                cols, vals, plan = coo_leaves(torch, h, G)
                bt = b_tiles_of(b[None].expand(G, -1, -1), meta).contiguous()
                yield dict(graph=name, F=int(b.shape[1]), G=G), (
                    cols, vals, bt, plan, meta.n_padded_rows)


def coo_lengths(rng, shape: dict) -> np.ndarray:
    """Entries a live row: ``longest``, then rows drawn log-uniform from
    ``COO_TAIL`` up to the shortest of them until the rows of at least
    ``COO_TAIL`` hold about ``tail`` entries, then short rows, geometric
    and under ``COO_TAIL``, that bring the total to ``entries``."""
    long = list(shape["longest"])
    while shape["tail"] - sum(long) >= COO_TAIL:
        hi = min(long[-1], shape["tail"] - sum(long))
        long.append(max(COO_TAIL, int(np.exp(rng.uniform(
            np.log(COO_TAIL), np.log(hi + 1))))))
    n = shape["live"] - len(long)
    left = shape["entries"] - sum(long)
    short = np.clip(rng.geometric(n / left, n), 1, COO_TAIL - 1)
    diff = left - int(short.sum())
    room = np.flatnonzero(short < COO_TAIL - 1 if diff > 0 else short > 1)
    short[rng.choice(room, abs(diff), replace=False)] += np.sign(diff)
    return np.concatenate([long, short]).astype(np.int64)


def shaped_coo_cases(torch, dev="cuda"):
    """(label, case) at the ``COO_SHAPES``: a COO-only partition of the
    shape's rows, its entries on random live rows in shuffled order and
    then class padding's (0, 0, +0) triples, at both layer widths, G = 1
    and the served group of 4; B is seeded normal (the kernel's time does
    not depend on its values). As ``coo_cases``."""
    from repro_torch.core import empty_ragged_ell
    from repro_torch.core.formats import (CooResidual, DenseTiles,
                                          PartitionMeta, TriPartition,
                                          b_tiles_of, plan_to,
                                          reduction_plan, stack_plans)

    t = 64
    for name, shape in COO_SHAPES.items():
        rng = np.random.default_rng(SEED)
        lengths = coo_lengths(rng, shape)
        n, pad = int(lengths.sum()), shape["padded"] - int(lengths.sum())
        rows = np.repeat(rng.choice(shape["rows"], lengths.size,
                                    replace=False), lengths)
        perm = rng.permutation(n)
        rows = np.concatenate([rows[perm], np.zeros(pad, np.int64)])
        cols = np.concatenate([rng.integers(0, shape["rows"], n),
                               np.zeros(pad, np.int64)])
        vals = np.concatenate([rng.standard_normal(n),
                               np.zeros(pad)]).astype(np.float32)
        nt = shape["rows"] // t
        meta = PartitionMeta(shape["rows"], shape["rows"], t, (), nt, nt,
                             0, 0, 0, 0, rows.size, (0.5, 0.01))
        leaves = CooResidual(*(torch.from_numpy(a.astype(np.int32))
                               for a in (rows, cols)),
                             torch.from_numpy(vals))
        member = reduction_plan(TriPartition(
            DenseTiles(np.zeros((0, t, t), np.float32),
                       np.zeros(0, np.int32), np.zeros(0, np.int32)),
            empty_ragged_ell(device="cpu"), leaves), meta)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for f in shape["widths"]:
            for G in (1, GROUP):
                cols_d, vals_d = (torch.stack([x] * G).to(dev)
                                  for x in (leaves.cols, leaves.vals))
                plan = plan_to(stack_plans([member] * G), dev)
                b = torch.randn((G, shape["rows"], f), generator=gen,
                                device=dev)
                yield dict(graph=name, F=f, G=G), (
                    cols_d, vals_d, b_tiles_of(b, meta), plan,
                    meta.n_padded_rows)


def coo_case(torch, case):
    """The flexible engine as the main path runs it: one ``coo_rows``
    launch, each live row's messages summed in plan order and added onto
    the rows it is given (here seeded normal rows, as the dense + ELL
    rows).

    Gates: bit for bit equal to its plain version (``coo_rows_ref``,
    which is the unfused ``hybrid_spmm.coo_matmul`` followed by the
    add), with the kernel's long-row threshold, with every row on the
    short path and with every row on the long path. Yardsticks: the
    plain version (the unfused chain, one CUDA graph) and
    ``torch.sparse.mm`` over a CSR of the live rows' entries, then
    ``index_add_`` onto those rows (``library_ms``). Also timed: every
    row on the short path (``short_only_ms``) and the long-row lengths
    of ``COO_LONG_ROWS`` (``long_row_ms``) in place of the kernel's own
    (``long_row``)."""
    from repro_torch.kernels import coo_spmm
    from repro_torch.kernels.coo_spmm import coo_rows, coo_rows_cost
    from repro_torch.kernels.ref import coo_rows_ref

    cols, vals, bt, plan, p = case
    g, nnz = cols.shape
    nct, t, f = bt.shape[1:]
    dev = bt.device
    rows = plan.coo_rows
    gen = torch.Generator(device=dev).manual_seed(SEED)
    y = torch.randn((g, p, f), generator=gen, device=dev)
    b3 = bt.reshape(g, nct * t, f)

    def kernel(out):
        return coo_rows(cols, vals, bt, plan.coo, rows, out, device=dev)

    def at(n, fn):
        own = coo_spmm.long_row
        coo_spmm.long_row = lambda entries: n
        try:
            return fn()
        finally:
            coo_spmm.long_row = own

    want = coo_rows_ref(cols, vals, b3, plan.coo, y.clone())
    got = kernel(y.clone())
    bitwise = torch.equal(got, want)
    short_bitwise = torch.equal(at(1 << 30, lambda: kernel(y.clone())), want)
    long_bitwise = torch.equal(at(1, lambda: kernel(y.clone())), want)
    # torch.sparse.mm over the live rows' CSR (int32 indices), built on
    # the host outside any timed region
    order = plan.coo.order.cpu().numpy()
    lengths = plan.coo.lengths.cpu().numpy()
    seg = np.repeat(np.arange(lengths.size), lengths)
    c = cols.cpu().numpy().reshape(-1).astype(np.int64)
    v = vals.float().cpu().numpy().reshape(-1)
    live_ids, pos = np.unique(seg, return_inverse=True)
    m = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([pos, (order // nnz) * nct * t
                                   + c[order]])),
        torch.from_numpy(v[order]), (live_ids.size, g * nct * t),
        check_invariants=False).coalesce().to_sparse_csr()
    csr = torch.sparse_csr_tensor(m.crow_indices().int(),
                                  m.col_indices().int(), m.values(),
                                  m.shape).to(dev)
    live_t = torch.from_numpy(live_ids).to(dev)
    b2 = b3.reshape(g * nct * t, f).float()
    buf, plain_buf, lib_buf = y.clone(), y.clone(), y.clone()
    length = coo_spmm.long_row(order.size)
    n_long = rows.n_at_least(length)
    top = np.sort(lengths)[::-1]
    cost = coo_rows_cost(cols, plan.coo, f, (
        str(vals.dtype).removeprefix("torch."),
        str(bt.dtype).removeprefix("torch.")))
    return dict(
        ok=bitwise and short_bitwise and long_bitwise, err=max_err(got, want),
        bitwise=bitwise, short_bitwise=short_bitwise,
        long_bitwise=long_bitwise, entries=int(order.size),
        live_rows=int(live_ids.size), long_row=length, long_rows=n_long,
        long_entries=int(top[:n_long].sum()), top=top[:4].tolist(),
        ms=device_ms(torch, lambda: kernel(buf)),
        call_ms=call_ms(torch, lambda: kernel(buf)),
        short_only_ms=at(1 << 30, lambda: device_ms(torch,
                                                    lambda: kernel(buf))),
        long_row_ms={n: at(n, lambda: device_ms(torch, lambda: kernel(buf)))
                     for n in COO_LONG_ROWS},
        plain_ms=device_ms(torch, lambda: coo_rows_ref(
            cols, vals, b3, plan.coo, plain_buf)),
        library_ms=device_ms(torch, lambda: lib_buf.view(g * p, f).index_add_(
            0, live_t, torch.sparse.mm(csr, b2))),
        bound=bound(cost["hbm_bytes"], cost["flops"]))


def coo_phase(torch, engine, graphs, launches: int, build_log) -> tuple:
    """Hold the COO row kernel against its plain version at the main
    path's shapes (cora, citeseer, pubmed; the first, cora at F = 128 and
    G = 1, heads the kernel table) and at the ``COO_SHAPES``, and time
    it; ``launches`` is the main path's count. Fails on a disagreement or
    on a spill of any instance. Returns (problems, the kernel table's
    entry)."""
    from repro_torch.kernels._build import ptxas_entries

    problems, rows = [], []
    print("COO row kernel (device ms a call, as the kernels below; long "
          "rows: at least long_row(entries) entries):")
    for label, case in itertools.chain(coo_cases(torch, engine, graphs),
                                       shaped_coo_cases(torch)):
        res = coo_case(torch, case)
        row = dict(label, **{k: res[k] for k in (
            "ms", "call_ms", "plain_ms", "library_ms", "short_only_ms",
            "long_row_ms", "bitwise", "short_bitwise", "long_bitwise",
            "entries", "live_rows", "long_row", "long_rows", "long_entries",
            "top")},
            bound_ms=res["bound"][0], bound_by=res["bound"][1],
            max_abs_err=res["err"])
        rows.append(row)
        print(f"  coo_rows {json.dumps(label):44s} kernel {res['ms']:.4f} ms "
              f"(call {res['call_ms']:.4f}; short rows only "
              f"{res['short_only_ms']:.4f}; long rows from "
              f"{json.dumps(res['long_row_ms'])})  plain "
              f"{res['plain_ms']:.4f} ms  library {res['library_ms']:.4f} "
              f"ms  bound {res['bound'][0]:.5f} ms ({res['bound'][1]})  "
              f"{res['entries']} entries onto {res['live_rows']} rows, "
              f"{res['long_rows']} long from {res['long_row']} "
              f"({res['long_entries']} entries), "
              f"longest {res['top']}  bitwise {res['bitwise']} / short "
              f"{res['short_bitwise']} / long {res['long_bitwise']}")
        if not res["ok"]:
            problems.append(f"coo_rows {label}: disagrees with its plain "
                            f"version ({res['err']}; {row})")
    log = build_log["coo_rows"]["log"]
    for e in ptxas_entries(log):
        if e["spill_stores"] or e["spill_loads"]:
            problems.append(f"coo_rows: {e['name']} spills "
                            f"{e['spill_stores']} / {e['spill_loads']} bytes")
    head = rows[0]   # cora: layer 1, G=1
    return problems, dict(
        name="coo_rows", route="cuda",
        source="src/repro_torch/kernels/csrc/coo_rows.cu",
        replaces="none (src/repro/core/hybrid_spmm.py coo_matmul: jnp.take "
                 "+ segment_sum)",
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        shape=", ".join(f"{k}={v}" for k, v in head.items()
                        if k in ("graph", "F", "G")),
        ptxas=ptxas_summary(log), cases=rows)


# The edge-coefficient kernels' Reddit-sized shape: the benchmark's
# gcn-reddit graph (A + I), its rows' neighbour lists, and the served
# GAT's head counts (layers 1-2 and 3).
GAT_SHAPE = dict(rows=232_965, entries=11_777_543, heads=(4, 6))


def gat_coef_case(torch, heads: int, dev="cuda") -> dict:
    """The GAT's edge softmax outside the engines at ``GAT_SHAPE``:
    ``gat_row_stats`` over 232 965 rows of neighbour lists (11 777 543
    entries, row lengths geometric about their mean, columns uniform),
    then ``gat_edge_coef`` over the entries laid out as one COO part
    (the per-slot work is the same in every layout), ``heads`` heads,
    scores seeded normal.

    Gates: the maxima bit for bit; each denominator within 2^-23 times
    its row's length, relative, of the plain version's (two float32 sums
    of the same positive terms in another order: the kernel's lanes and
    shuffles, the plain version's one chain); the coefficients within
    1e-6 relative (CUDA's ``expf`` and PyTorch's exponential). Yardsticks: the plain versions (CUDA events
    around one call: ``repeat_interleave`` reads its lengths on the host,
    so they cannot be captured in a graph), and each
    kernel's bound from its bytes (``gat_coef.row_stats_work``; for the
    coefficients each slot's value, row, column and H outputs, and s, t
    and m once a row and head)."""
    from repro_torch.core.formats import (CooResidual, DenseTiles,
                                          TriPartition, empty_ragged_ell)
    from repro_torch.kernels import gat_coef
    from repro_torch.kernels.ref import gat_edge_coef_ref, gat_row_stats_ref

    rng = np.random.default_rng(SEED)
    n, e = GAT_SHAPE["rows"], GAT_SHAPE["entries"]
    lengths = rng.geometric(n / e, n)
    lengths = np.maximum((lengths * (e / lengths.sum())).astype(np.int64), 1)
    lengths[: e - int(lengths.sum())] += 1
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])
                               ).to(dev)
    e = int(lengths.sum())
    cols = torch.from_numpy(rng.integers(0, n, e).astype(np.int32)).to(dev)
    rows = torch.from_numpy(np.repeat(np.arange(n), lengths).astype(
        np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s = torch.randn((1, n, heads), generator=gen, device=dev) * 3
    t = torch.randn((1, n, heads), generator=gen, device=dev) * 3
    part = TriPartition(
        DenseTiles(*(torch.zeros(shape, dtype=dt, device=dev) for shape, dt in
                     (((1, 0, 64, 64), torch.float32),
                      ((1, 0), torch.int32), ((1, 0), torch.int32)))),
        type(empty_ragged_ell(device=dev))(*(
            x[None] for x in empty_ragged_ell(device=dev))),
        CooResidual(rows[None], cols[None],
                    torch.ones((1, e), dtype=torch.float32, device=dev)))
    m, d = gat_coef.gat_row_stats(offsets, cols, s, t, 0.2, device=dev)
    coef = gat_coef.gat_edge_coef(part, s, t, m, 0.2, 64, device=dev)[2]
    mw, dw = gat_row_stats_ref(offsets, cols, s, t, 0.2)
    cw = gat_edge_coef_ref(part, s, t, m, 0.2, 64)[2]
    lens = torch.from_numpy(lengths).to(dev)[None, :, None].float()
    d_over = float(((d - dw).abs() / (dw * lens * 2.0 ** -23)).max())
    rel = float(((coef - cw).abs() / cw.abs().clamp_min(1e-30)).max())
    ok = torch.equal(m, mw) and d_over <= 1.0 and rel <= 1e-6
    stats_bytes, stats_flops = gat_coef.row_stats_work(n, e, heads)
    coef_bytes = e * (4 + 4 + 4 + 4 * heads) + 3 * 4 * n * heads
    return dict(
        heads=heads, rows=n, entries=e, ok=ok, max_rel_err=rel,
        d_err_over_bound=d_over,
        stats_ms=device_ms(torch, lambda: gat_coef.gat_row_stats(
            offsets, cols, s, t, 0.2, device=dev)),
        stats_plain_ms=call_ms(torch, lambda: gat_row_stats_ref(
            offsets, cols, s, t, 0.2)),
        stats_bound=bound(stats_bytes, stats_flops),
        coef_ms=device_ms(torch, lambda: gat_coef.gat_edge_coef(
            part, s, t, m, 0.2, 64, device=dev)),
        coef_plain_ms=call_ms(torch, lambda: gat_edge_coef_ref(
            part, s, t, m, 0.2, 64)),
        coef_bound=bound(coef_bytes, 6.0 * e * heads))


def gat_coef_phase(torch, build_log, launches: dict, dev="cuda") -> tuple:
    """Hold the edge-coefficient kernels against their plain versions at
    ``GAT_SHAPE`` for each head count, and time them and their bounds.
    Fails on a disagreement or on a spill of any instance. ``launches``:
    each kernel's launches in one served GAT request
    (``gat_served_phase``). Returns (problems, the kernel table's
    entry)."""
    from repro_torch.kernels._build import ptxas_entries

    problems, rows = [], []
    print("GAT edge-coefficient kernels (device ms a call, Reddit-sized):")
    for h in GAT_SHAPE["heads"]:
        r = gat_coef_case(torch, h, dev)
        rows.append(r)
        print(f"  heads {h}: row stats {r['stats_ms']:.4f} ms (plain "
              f"{r['stats_plain_ms']:.4f}, bound {r['stats_bound'][0]:.4f} "
              f"{r['stats_bound'][1]})  coefficients {r['coef_ms']:.4f} ms "
              f"(plain {r['coef_plain_ms']:.4f}, bound "
              f"{r['coef_bound'][0]:.4f} {r['coef_bound'][1]})  "
              f"{r['entries']} entries, coefficients' max rel err "
              f"{r['max_rel_err']:.3g}, denominators' err / bound "
              f"{r['d_err_over_bound']:.3g}")
        if not r["ok"]:
            problems.append(f"gat_coef heads {h}: disagrees with its plain "
                            f"version ({r})")
    log = build_log["gat_coef"]["log"]
    for e in ptxas_entries(log):
        if e["spill_stores"] or e["spill_loads"]:
            problems.append(f"gat_coef: {e['name']} spills "
                            f"{e['spill_stores']} / {e['spill_loads']} bytes")
    head = rows[0]
    return problems, dict(
        name="gat_coef", route="cuda",
        source="src/repro_torch/kernels/csrc/gat_coef.cu",
        replaces="none (the reference serves the GCN alone)",
        launches=launches, ms=head["stats_ms"] + head["coef_ms"],
        plain_ms=head["stats_plain_ms"] + head["coef_plain_ms"],
        bound_ms=head["stats_bound"][0] + head["coef_bound"][0],
        shape=f"rows={head['rows']}, entries={head['entries']}, "
              f"heads={head['heads']}",
        ptxas=ptxas_summary(log), cases=rows)


# The served GAT at the paper's inductive widths, as the benchmark's
# gat-reddit configuration: (heads, head width, concat, ELU, skip) a
# layer; 41 is Reddit's class count.
GAT_LAYERS = ((4, 256, True, True, False), (4, 256, True, True, True),
              (6, 41, False, False, False))
# float32 logits against the float64 plain forward, max |y - ref| over
# max |ref| (the gat-reddit configuration's limit)
GAT_LOGIT_ERR = 2e-5


def same_bits(a, b) -> bool:
    """Bitwise equal float32 tensors, the sign of zero included."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def gat_served_phase(torch, dev="cuda", scale: float = 1.0) -> tuple:
    """The GAT served through ``Engine.register(..., model="gat")`` at
    ``GAT_LAYERS`` on the program's Reddit-sized graph (232 965
    vertices, density 0.0004, labels reorder), then its kernels on the
    registered partition.

    Gates: the partition fills all three layouts; one launch of each
    engine kernel and of each edge-coefficient kernel a layer, for
    ``infer`` and for a group of two (``serve_group``), the counters set
    to 0 just before each; each member of the group bitwise its own
    ``infer``; the logits within ``GAT_LOGIT_ERR`` of the float64 plain
    forward (``models.gat_ref``). Then, at each served (H, F') = (4, 256)
    and (6, 41), with seeded scores and B over the registered partition:
    the edge-coefficient kernels against their plain versions in all
    three layouts (row maxima bit for bit, each denominator within
    2^-23 times its row's length, relative, zero where a row has no
    neighbour; the coefficients within 1e-6 relative and zero exactly
    where the layout holds no entry); the multi-head ELL and COO engines
    bitwise their plain versions (``ragged_ell_rows_ref``,
    ``coo_rows_ref``) a head at a time, on the head's values and
    columns (a head's columns depend on that head alone, and at F = 1024
    the ELL plain version would gather 40 GB of B tiles at once); the
    multi-head dense engine bitwise the
    single-value kernel run on each head's columns and within
    ``KERNEL_TOL`` of its plain version (``bsr_heads_ref``, which adds
    each 64-term dot product in another order, as ``bsr_case`` says);
    one launch of each engine. ``scale`` < 1 shrinks the graph. Returns
    (problems, record)."""
    from repro_torch.core.formats import b_tiles_of
    from repro_torch.core.gat import GatLayer
    from repro_torch.data.graphs import make_paper_dataset
    from repro_torch.engine import Engine
    from repro_torch.kernels import gat_coef, ops
    from repro_torch.kernels.ref import (bsr_spmm_rows_ref, coo_rows_ref,
                                         gat_edge_coef_ref,
                                         gat_row_stats_ref,
                                         ragged_ell_rows_ref)
    from repro_torch.models.gat_ref import gat_forward_ref

    t_phase = time.perf_counter()
    problems, dev, name = [], torch.device(dev), "reddit-gat"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    csr, x0, _, st = make_paper_dataset("reddit", scale=scale, seed=SEED)
    labels = make_paper_dataset.last_labels
    rng = np.random.default_rng(SEED)
    layers, f = [], st.n_features
    for heads, width, concat, elu, skip in GAT_LAYERS:
        layers.append(GatLayer(glorot(rng, f, heads * width),
                               glorot(rng, heads, width),
                               glorot(rng, heads, width), concat=concat,
                               elu=elu, skip=skip))
        f = heads * width if concat else width
    engine = Engine(device=dev)
    t0 = time.perf_counter()
    h = engine.register(name, csr, reorder="labels", labels=labels,
                        weights=layers, model="gat")
    register_s = time.perf_counter() - t0
    layouts = dict(dense_tiles=int(h.meta.n_dense_tiles),
                   ell_entries=int(h.meta.nnz_ell),
                   coo_entries=int(h.meta.nnz_coo))
    if not all(layouts.values()):
        problems.append(f"gat: a layout of the Reddit partition is empty "
                        f"({layouts})")
    xs = [x0, (rng.random(x0.shape) < 0.05).astype(np.float32)]

    def counted(fn):
        ops.reset_launch_counts()
        gat_coef.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        c = dict(ops.launch_counts())
        c.update({f"gat_{k}": v for k, v in gat_coef.launches.items()})
        return out, c

    n_layers = len(GAT_LAYERS)
    want = dict(bsr_spmm=n_layers, ragged_ell_spmm=n_layers, ell_spmm=0,
                tile_matmul=0, coo_rows=n_layers, gat_row_stats=n_layers,
                gat_edge_coef=n_layers)
    y1, c_infer = counted(lambda: engine.infer(name, xs[0]))
    ys, c_group = counted(lambda: engine.serve_group(
        [(name, x) for x in xs]))
    for what, c in (("infer", c_infer), ("serve_group of 2", c_group)):
        if c != want:
            problems.append(f"gat: {what} launches {c}, want {want}")
    group_bitwise = same_bits(ys[0], y1) and same_bits(
        ys[1], engine.infer(name, xs[1]))
    if not group_bitwise:
        problems.append("gat: a member of serve_group is not bitwise its "
                        "own infer")
    ref = gat_forward_ref(csr.indptr, csr.indices,
                          torch.from_numpy(xs[0]).to(dev), layers,
                          dtype=torch.float64)
    logit_err = float((y1.double() - ref).abs().max() / ref.abs().max())
    if not logit_err <= GAT_LOGIT_ERR:
        problems.append(f"gat: logits {logit_err:.3g} from the float64 "
                        f"plain forward (limit {GAT_LOGIT_ERR})")
    del ref, ys
    x_dev = torch.from_numpy(xs[0]).to(dev)
    infer_ms = wall_ms(torch, lambda: engine.infer(name, x_dev))

    part = type(h.part)(*(type(c)(*(a[None] for a in c)) for c in h.part))
    meta, plan, p = h.padded_meta, h.plan, h.padded_meta.n_padded_rows
    lengths = torch.as_tensor(np.diff(h.host_rows.offsets)).to(dev)
    lengths = lengths[None, :, None].float()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for heads, width in ((4, 256), (6, 41)):
        f = heads * width
        s = torch.randn((1, p, heads), generator=gen, device=dev) * 3
        t = torch.randn((1, p, heads), generator=gen, device=dev) * 3
        mx, d = gat_coef.gat_row_stats(h.rows.offsets, h.rows.cols, s, t,
                                       0.2, device=dev)
        coef = gat_coef.gat_edge_coef(part, s, t, mx, 0.2, meta.tile,
                                      device=dev)
        mw, dw = gat_row_stats_ref(h.rows.offsets, h.rows.cols, s, t, 0.2)
        live = dw > 0
        d_over = float(torch.where(
            live, (d - dw).abs() / (dw * lengths * 2.0 ** -23), 0.0).max())
        stats_ok = (torch.equal(mx, mw) and d_over <= 1.0
                    and bool((d[~live] == 0).all()))
        coef_rel, zeros_ok = {}, True
        for what, got, exp in zip(("dense", "ell", "coo"), coef,
                                  gat_edge_coef_ref(part, s, t, mx, 0.2,
                                                    meta.tile)):
            zeros_ok = zeros_ok and torch.equal(got == 0, exp == 0)
            coef_rel[what] = float(((got - exp).abs()
                                    / exp.abs().clamp_min(1e-30)).max())
        coef_ok = zeros_ok and max(coef_rel.values()) <= 1e-6
        b = torch.randn((1, p, f), generator=gen, device=dev)
        zeros = torch.zeros((1, p, f), device=dev)
        ops.reset_launch_counts()
        yd = ops.dense_heads_matmul(part, coef[0], b, meta, plan)
        ye = ops.ell_heads_matmul(part, coef[1], b, meta, plan, zeros.clone())
        yc = ops.coo_heads_matmul(part, coef[2], b, meta, plan, zeros.clone())
        torch.cuda.synchronize()
        engine_launches = {k: v for k, v in ops.launch_counts().items() if v}
        ell_bitwise = coo_bitwise = dense_bitwise = True
        for k in range(heads):
            cols = slice(k * width, (k + 1) * width)
            bk = b[..., cols].contiguous()
            zk = torch.zeros((1, p, width), device=dev)
            ell_bitwise = ell_bitwise and same_bits(
                ye[..., cols].contiguous(), ragged_ell_rows_ref(
                    part.ell.cols, coef[1][..., k:k + 1], part.ell.tile_col,
                    part.ell.unit_k, b_tiles_of(bk, meta), plan.ell,
                    zk.clone(), segments=tuple(meta.ell_segments)))
            coo_bitwise = coo_bitwise and same_bits(
                yc[..., cols].contiguous(), coo_rows_ref(
                    part.coo.cols, coef[2][..., k:k + 1], bk, plan.coo,
                    zk.clone()))
            one = type(part)(part.dense._replace(
                tiles=coef[0][:, :, k].contiguous()), part.ell, part.coo)
            dense_bitwise = dense_bitwise and same_bits(
                yd[..., cols].contiguous(), ops.dense_tiles_matmul(
                    one, bk, meta, plan))
        bt = b_tiles_of(b, meta)
        want_d = bsr_spmm_rows_ref(coef[0], part.dense.tile_col, bt,
                                   plan.dense).reshape(yd.shape)
        scale = bsr_spmm_rows_ref(coef[0].abs(), part.dense.tile_col,
                                  bt.abs(), plan.dense).reshape(yd.shape)
        dense_close = bool(((yd - want_d).abs() <= KERNEL_TOL["atol"]
                            + KERNEL_TOL["rtol"] * scale).all())
        row = dict(heads=heads, width=width, stats_ok=stats_ok,
                   d_err_over_bound=d_over, coef_max_rel_err=coef_rel,
                   coef_zeros_ok=zeros_ok, dense_bitwise=dense_bitwise,
                   dense_close=dense_close,
                   dense_err=max_err(yd, want_d), ell_bitwise=ell_bitwise,
                   coo_bitwise=coo_bitwise, launches=engine_launches)
        cases.append(row)
        print(f"  gat (H, F') = ({heads}, {width}): " + json.dumps(row))
        bad = [k for k in ("stats_ok", "dense_bitwise", "dense_close",
                           "ell_bitwise", "coo_bitwise") if not row[k]]
        if not coef_ok:
            bad.append("coefficients")
        if engine_launches != {"bsr_spmm": 1, "ragged_ell_spmm": 1,
                               "coo_rows": 1}:
            bad.append(f"launches {engine_launches}")
        if bad:
            problems.append(f"gat ({heads}, {width}) on the Reddit "
                            f"partition: {bad}")
        del coef, b, yd, ye, yc, bt, want_d, scale, zeros
    record = dict(
        graph="reddit", n=int(h.n_rows), nnz=int(csr.indices.shape[0]),
        register_s=register_s, phases=dict(h.phases), layouts=layouts,
        split_rows=dict(h.split_rows), class_=h.sclass.summary(),
        launches={"infer": c_infer, "group2": c_group},
        group_bitwise=group_bitwise, logit_err=logit_err,
        infer_ms=infer_ms, cases=cases,
        peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        phase_s=time.perf_counter() - t_phase)
    del engine, h, part, x_dev, y1
    torch.cuda.empty_cache()
    return problems, record


KERNELS = (
    ("ragged_ell_spmm", "src/repro_torch/kernels/csrc/ragged_ell_spmm.cu",
     "src/repro/kernels/ell_spmm.py:433", ell_case, "ell"),
    ("bsr_spmm", "src/repro_torch/kernels/csrc/bsr_spmm.cu",
     "src/repro/kernels/bsr_spmm.py:28", bsr_case, "sparse"),
    ("ell_spmm", "src/repro_torch/kernels/csrc/ell_spmm.cu",
     "src/repro/kernels/ell_spmm.py:322", fixed_ell_case, "ell"),
    ("tile_matmul", "src/repro_torch/kernels/csrc/tile_matmul.cu",
     "src/repro/kernels/tile_matmul.py:66", matmul_case, "matmul"),
)


def kernel_phase(torch, engine, graphs, launches, matmul_cases,
                 build_log, reordered: dict) -> tuple:
    """Hold each kernel against its plain version at every shape its path
    gave it, and time it. ``launches`` maps each kernel to the count of
    its path's run, or to {path: count} for a kernel of several paths
    (``launches`` is then the first path's count); ``build_log`` is the
    build's log, whose ptxas lines each entry carries. The ELL kernels
    also run at the shapes of the ``reordered`` graphs ({name: the graph
    whose features and weights it serves}: cora and pubmed reordered by
    labels, whose classes put every tile into the ELL engine and have
    several K bands; pubmed's at G = 1 only)."""
    problems, entries = [], []
    ell = list(kernel_cases(torch, engine, dict(
        graphs, **{n: graphs[src] for n, src in reordered.items()}),
        groups={n: (1,) for n, src in reordered.items() if src != "cora"}))
    cases = {"sparse": [c for c in ell if c[0]["graph"] not in reordered],
             "ell": ell,
             "matmul": [(dict(graph=name, layer=layer,
                              shape=[int(a.shape[0]), int(a.shape[1]),
                                     int(w.shape[1])]), (a, w))
                        for name, layer, a, w in matmul_cases]}
    for kname, source, replaces, run, kind in KERNELS:
        rows = []
        for label, case in cases[kind]:
            res = run(torch, case)
            row = dict(label, ms=res["ms"], call_ms=res["call_ms"],
                       plain_ms=res["plain_ms"], library_ms=res["library_ms"],
                       bound_ms=res["bound"][0], bound_by=res["bound"][1],
                       max_abs_err=res["err"])
            for extra in ("launches_per_call", "folded_bitwise",
                          "loop_bitwise", "ragged_bitwise", "kmax_bitwise",
                          "kmax_ms", "trips", "bands",
                          "parent_loop_chain_ms",
                          "kernels_per_call", "parent_chain_kernels",
                          "parent_loop_chain_kernels",
                          "per_tile_ok", "tiles_summed", "row_tiles",
                          "per_tile_ms", "library_bmm_ms",
                          "configs_bitwise", "config_ms", "per_unit_ok",
                          "entries", "live_rows", "parent_chain_ms",
                          "per_unit_ms", "per_unit_bound_ms",
                          "library_all_rows_ms", "library_all_rows_top",
                          "counts"):
                if extra in res:
                    row[extra] = res[extra]
            rows.append(row)
            if "counts" in res:
                # the bound's bytes and operations by the kernel module's
                # contract_cost against this script's own count
                (cb, cf), (sb, sf) = (res["counts"]["contract_cost"],
                                      res["counts"]["smoke"])
                print(f"    bound counts: contract_cost {cb:.0f} B "
                      f"{cf:.0f} ops, smoke {sb:.0f} B {sf:.0f} ops")
                if (abs(cb - sb) > COST_TOL * sb
                        or abs(cf - sf) > COST_TOL * sf):
                    problems.append(f"{kname} {label}: contract_cost "
                                    f"{[cb, cf]} against the smoke's "
                                    f"count {[sb, sf]}")
            print(f"  {kname:16s} {json.dumps(label):52s} kernel "
                  f"{res['ms']:.4f} ms (call {res['call_ms']:.4f})  plain "
                  f"{res['plain_ms']:.4f} ms  library "
                  f"{res['library_ms']:.4f} ms  bound "
                  f"{res['bound'][0]:.5f} ms "
                  f"({res['bound'][1]})  max_abs_err {res['err']:.3g}")
            if "trips" in res:
                print(f"    K trips: {res['trips']['kmax']} at Kmax, "
                      f"{res['trips']['bounded']} at the "
                      + ("band K (Kmax pass "
                         f"{res['kmax_ms']:.4f} ms, bitwise "
                         f"{res['kmax_bitwise']})" if "kmax_ms" in res
                         else "bucket K (ragged bitwise "
                         f"{res['ragged_bitwise']})"))
            if "config_ms" in res:
                print("    configs " + json.dumps(res["config_ms"])
                      + f" bitwise {res['configs_bitwise']}")
            if "library_bmm_ms" in res:
                print(f"    per-tile kernel {res['per_tile_ms']:.4f} ms  "
                      f"torch.bmm alone {res['library_bmm_ms']:.4f} ms  "
                      f"folded bitwise {res['folded_bitwise']}  tiles "
                      f"{res['tiles_summed']} over {res['row_tiles']} "
                      "row tiles")
            if "parent_loop_chain_ms" in res:
                print(f"    parent chains: fused {res['parent_chain_ms']:.4f} "
                      f"ms, loop {res['parent_loop_chain_ms']:.4f} ms "
                      f"(per-unit kernels alone {res['per_unit_ms']:.4f}); "
                      f"kernels per call {res['kernels_per_call']} (chains "
                      f"{res['parent_chain_kernels']}, "
                      f"{res['parent_loop_chain_kernels']})  "
                      f"bitwise fused {res['folded_bitwise']} loop "
                      f"{res['loop_bitwise']}  [K, units] per bucket "
                      f"{res['bands']}")
            elif "parent_chain_ms" in res:
                print(f"    parent chain {res['parent_chain_ms']:.4f} ms  "
                      f"sparse.mm over all rows + add "
                      f"{res['library_all_rows_ms']:.4f} ms "
                      f"{json.dumps(res['library_all_rows_top'])}  "
                      f"per-unit kernel {res['per_unit_ms']:.4f} ms (bound "
                      f"{res['per_unit_bound_ms']:.5f})  folded bitwise "
                      f"{res['folded_bitwise']}  {res['entries']} unit rows "
                      f"onto {res['live_rows']} live rows")
            if not res["ok"]:
                why = {k: res[k] for k in ("folded_bitwise", "loop_bitwise",
                                           "ragged_bitwise", "kmax_bitwise",
                                           "per_unit_ok", "per_tile_ok",
                                           "configs_bitwise",
                                           "launches_per_call") if k in res}
                problems.append(f"{kname} {label}: disagrees with its plain "
                                f"version ({res['err']}; {why})")
        head = rows[0]   # cora: layer 1 of the first dispatch, G=1
        n = launches[kname]
        by_path = dict(launches_by_path=n) if isinstance(n, dict) else {}
        entries.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=next(iter(n.values())) if by_path else n, **by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            shape=", ".join(f"{k}={v}" for k, v in head.items()
                            if k in ("graph", "F", "G", "layer", "shape")),
            ptxas=ptxas_summary(build_log[os.path.basename(source)[:-3]]
                                ["log"]),
            cases=rows))
    return problems, entries


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke needs a GPU")
    src = os.path.join(HERE, "src")
    sys.path.insert(0, src)
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"cannot import the port from {src}: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t_start = t0 = time.perf_counter()
    log = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(log)} sources")
    for name, entry in sorted(log.items()):
        print(f"  {name}: {'cached' if entry['cached'] else 'built'}")
        for line in ptxas_summary(entry["log"]):
            print(f"    {line}")

    engine, graphs, counts = main_path(torch)
    print(f"main path launches: {counts}")
    problems = check_main_path(torch, engine, graphs, counts)
    for name, g in graphs.items():
        x_dev = torch.from_numpy(g["xs"][0]).cuda()
        g["profile"] = profile_calls(torch, lambda: engine.infer(name,
                                                                 x_dev))

    s_problems, serving = serving_phase(torch, engine, graphs, smi)
    problems += s_problems
    for mode in ("serial", "pipelined", "replicas", "chaos_poison",
                 "chaos_hang"):
        r = serving[mode]
        print(f"serving {mode}: {r['completed']} completed in "
              f"{r['batches']} batches, p50 {r['p50_ms']:.3f} ms, p99 "
              f"{r['p99_ms']:.3f} ms, wall {r['wall_s']:.3f} s, overlap "
              f"{r['overlap_ratio']:.3f}, inflight peak "
              f"{r['inflight_peak']}")

    r_problems, reordered, r_counts = reordered_phase(torch, engine, graphs)
    problems += r_problems
    print(f"reordered graph launches: {r_counts}")
    print("  " + json.dumps(reordered))

    ab_problems, ab_rows, ab_counts = dispatch_ab(torch, graphs)
    problems += ab_problems
    for d, c in ab_counts.items():
        print(f"dispatch A/B launches, {d}: {c}")
    for row in ab_rows:
        print("  " + json.dumps(row))

    lc_inputs = lifecycle_inputs(torch)
    lifecycle = []
    for d in LIFECYCLE_DISPATCHES:
        lc_problems, record, _ = lifecycle_phase(torch, lc_inputs, d)
        problems += lc_problems
        lifecycle.append(record)
        print(f"lifecycle {d}: " + json.dumps(record))

    mm_problems, mm_cases, mm_counts = matmul_path(torch, engine, graphs)
    problems += mm_problems
    print(f"matmul path launches: {mm_counts}")

    xw_problems, xw = xw_phase(torch, engine, graphs)
    problems += xw_problems

    tuned_names = ("cora", "pubmed", reordered["graph"])
    at_problems, autotune, tuned_forward = autotune_phase(
        torch, engine, graphs, tuned_names)
    problems += at_problems
    print(f"autotune stats: {engine.stats()['autotune']}")
    lint_problems, lint = lint_phase(torch, engine, graphs, tuned_names)
    problems += lint_problems
    print(f"lint: {lint}")

    tr_problems, train, tr_counts, bwd_kernels, bwd_launches = train_phase(
        torch, smi)
    problems += tr_problems
    print(f"train path launches: {tr_counts}; backward launches of the "
          f"training runs: {bwd_launches}")
    for rec in train["graphs"]:
        print("  " + json.dumps(rec))

    lm_problems, lm = lm_phase(torch, smi)
    problems += lm_problems
    print(f"lm: {QWEN} train step {lm['train']['wall_ms']:.1f} ms "
          f"(device {lm['train']['device_ms']:.1f} ms), losses "
          f"{lm['train']['losses'][0]:.3f} -> {lm['train']['losses'][-1]:.3f}"
          f"; prefill {PREFILL_SEQ} {lm['prefill']['wall_ms']:.1f} ms; "
          f"decode {lm['decode']['ms_per_token']:.2f} ms/token; phase "
          f"{lm['phase_s']:.1f} s")
    fm_problems, fm = fm_phase(torch, smi)
    problems += fm_problems
    print(f"fm: train step {fm['train']['wall_ms']:.1f} ms, serve "
          f"{fm['serve']['wall_ms']:.3f} ms, retrieval "
          f"{fm['retrieval']['wall_ms']:.2f} ms; phase {fm['phase_s']:.1f} s")

    geo_problems, geo = geometric_phase(torch, smi)
    problems += geo_problems
    for rec in geo["models"]:
        print(f"geometric: {rec['arch']} serve {rec['serve']['wall_ms']:.2f}"
              f" ms (device {rec['serve']['device_ms']:.3f}), train step "
              f"{rec['train']['wall_ms']:.2f} ms (device "
              f"{rec['train']['device_ms']:.3f}), losses "
              f"{rec['train']['losses'][0]:.4f} -> "
              f"{rec['train']['losses'][-1]:.4f}")
    print(f"geometric: grouped gradient {geo['grouped_grad']}; phase "
          f"{geo['phase_s']:.1f} s")

    sh_problems, sharded = sharded_phase(torch, smi)
    problems += sh_problems
    g, m = sharded["gatedgcn"], sharded["moe"]
    print(f"sharded (NCCL, 1 rank, (1, 1) mesh): gatedgcn halo step "
          f"{g['wall_ms']:.1f} ms (device {g['device_ms']:.2f} ms, "
          f"{g['kernels']:.0f} kernels, busy {g['busy_share']:.3f}, halo "
          f"exchange {g['halo_exchange_share']:.4f} of device time, "
          f"{g['exchanges_per_step']} exchanges), losses "
          f"{g['losses'][0]:.4f} -> {g['losses'][-1]:.4f}, equal to "
          f"unsharded {g['equal_to_unsharded']}; {MOE_ARCH} EP layer bf16 "
          f"{m['bf16']['ms']['moe_ffn_ep']:.2f} ms (moe_ffn "
          f"{m['bf16']['ms']['moe_ffn']:.2f}), f32 no-drop equal "
          f"{m['f32_nodrop']['equal']}, {MOE_LAYERS}-layer forward equal "
          f"{m['forward']['equal']}, prefill/decode equal "
          f"{m['prefill_decode']['equal']}")
    for r in sharded["tp_paths"]:
        print(f"sharded path {r['path']}: {r['arch']} "
              f"{r.get('strategy', 'halo')} step {r['sharded']['wall_ms']:.1f}"
              f" ms (device {r['sharded']['device_ms']:.1f} ms, NCCL "
              f"{r['sharded']['nccl_share']:.4f}) vs unsharded "
              f"{r['unsharded']['wall_ms']:.1f} ms (device "
              f"{r['unsharded']['device_ms']:.1f}); collectives "
              f"{r['collectives']}; equal to unsharded "
              f"{r['equal_to_unsharded']}; losses {r['losses']}")
    for row in sharded["gloo_tp_check"]["cases"]:
        print(f"sharded gloo check (CPU): {row['case']} on {row['ranks']} "
              f"ranks, max |err| {row['max_abs_err']:.3g}, within tol "
              f"{row['within_tol']}")
    c = sharded["gloo_check"]
    print(f"sharded gloo check (CPU, {c['ranks']} gloo ranks, mesh "
          f"{c['mesh']}): max |err| vs one rank {c['max_abs_err']:.3g}, "
          f"ranks equal {c['ranks_equal']}, {c['seconds']:.1f} s; cora "
          f"out-of-halo {sharded['cora_out_of_halo']}; phase "
          f"{sharded['phase_s']:.1f} s")

    sv_problems, serving_tp = serving_tp_phase(torch, smi)
    problems += sv_problems
    for r in serving_tp["paths"]:
        if r["path"] == "J":
            print(f"serving path J ({smi}): {r['arch']} {r['cell']} "
                  f"{r['layers']} layers, {r['slots']} slots, decode "
                  f"{r['sharded']['wall_ms']:.1f} ms (device "
                  f"{r['sharded']['device_ms']:.2f}) vs unsharded "
                  f"{r['unsharded']['wall_ms']:.1f}; collectives "
                  f"{r['collectives']}; equal {r['equal']}")
            continue
        for v, rec in r["variants"].items():
            pre, dec = rec["prefill"], rec["decode"]
            print(f"serving path {r['path']} ({smi}): {r['arch']} "
                  f"{r['layers']} layers, MoE {v}: prefill "
                  f"{r['prefill']['batch']}x{r['prefill']['seq']} "
                  f"{pre['wall_ms']:.1f} ms (device span "
                  f"{pre['device_span_ms']:.1f}, unsharded "
                  f"{r['prefill']['unsharded']['wall_ms']:.1f}), "
                  f"{pre['per_s']:.0f} tokens/s, equal {pre['equal']}; "
                  f"decode {r['decode']['batch']} x "
                  f"{r['decode']['slots']} slots "
                  f"{dec['wall_ms']:.1f} ms a token"
                  f" (device {dec['device_ms']:.2f}), equal {dec['equal']};"
                  f" collectives a decode {dec['collectives']}")
    c = serving_tp["cells"]
    print(f"serving path K: cells ok / skipped: {c['1x1']} on (1, 1), "
          f"{c['16x16']} on 16x16; gloo serving check (CPU) "
          f"{sum(r['within_tol'] for r in serving_tp['gloo_check']['cases'])}"
          f" of {len(serving_tp['gloo_check']['cases'])} cases within tol;"
          f" phase {serving_tp['phase_s']:.1f} s")

    dr_problems, dry = dryrun_phase(torch, smi)
    problems += dr_problems
    for r in dry["cells"]:
        if r["status"] == "ok":
            print(f"dryrun (a) 16x16 {r['cell']}: bottleneck "
                  f"{r['bottleneck']}, t_bound {r['t_bound']:.4g} s, "
                  f"mfu_bound {r['mfu_bound']:.4g}, peak "
                  f"{r['per_device_memory'] / 2**30:.2f} GiB, traced in "
                  f"{r['trace_s']:.1f} s")
        else:
            print(f"dryrun (a) 16x16 {r['cell']}: {r['status']}")
    print(f"dryrun (a): {dry['status']} in {dry['trace_s']:.1f} s "
          f"({dry['jobs']} processes, host only), traced on "
          f"{dry['traced_on']}")
    for name, r in dry["mixtral_vs_pr25"].items():
        print(f"dryrun (a) 16x16 {name} a rank, PR 25 -> now: all-reduce "
              f"{r['all_reduce_bytes'][0]:.4g} -> "
              f"{r['all_reduce_bytes'][1]:.4g} B, FLOPs "
              f"{r['flops'][0]:.4g} -> {r['flops'][1]:.4g}, peak "
              f"{r['peak_bytes'][0] / 2**30:.2f} -> "
              f"{r['peak_bytes'][1] / 2**30:.2f} GiB")
    print(f"dryrun (b) meta traces equal to the card's device's: "
          f"{dry['meta_equal']}")
    for r in dry["predicted_vs_measured"]:
        print(f"dryrun (b) {r['arch']}/{r['cell']} ({smi}): measured "
              f"{r['measured_ms']:.3f} ms, t_bound {r['t_bound_ms']:.3f} ms "
              f"({r['bottleneck']}); FLOPs traced/run {r['flops']}; bytes "
              f"traced/run {r['bytes']}; peak bytes traced/card "
              f"{r['peak_bytes']}; collectives {r['collectives'][1]}; "
              f"traced on {r['traced_on']}")
    print(f"dryrun (c) fm cells equal to the unsharded steps: "
          f"{dry['fm_cells_equal']}; phase {dry['phase_s']:.1f} s")

    ck_problems, ckpt = checkpoint_phase(torch, smi)
    problems += ck_problems
    print(f"checkpoint ({smi}): {ckpt['arch']} {ckpt['strategy']} state, "
          f"{ckpt['leaves']} leaves, {ckpt['bytes_written']} bytes written;"
          f" save {ckpt['save_s']:.2f} s (gather; write committed after "
          f"{ckpt['commit_s']:.2f} s more), restore {ckpt['restore_s']:.2f}"
          f" s; next step equal to the unsaved run's "
          f"{ckpt['equal_to_unsaved']}; phase {ckpt['phase_s']:.1f} s")

    e2e = []
    for name, g in graphs.items():
        h = engine.handle(name)
        prof = g["profile"]
        row = dict(graph=name, n=g["n"], register_s=g["register_s"],
                   infer_ms=g["infer_ms"], infer_dev_ms=g["infer_dev_ms"],
                   group4_ms=g["group_ms"],
                   err_vs_torch=g["err_vs_torch"],
                   err_group_vs_infer=g["err_group_vs_infer"],
                   group_bitwise_infer=g["group_bitwise_infer"],
                   shape_class=h.sclass.summary(), profile=prof)
        e2e.append(row)
        print(f"  {name}: " + json.dumps(row))
    b16_problems, bf16_gcn, bf16_launches, bf16_windows = bf16_phase(
        torch, engine, graphs)
    problems += b16_problems
    print("bf16 path launches by type, one window a dispatch (and "
          f"ops.matmul's): {json.dumps(bf16_windows)}")
    for rec in bf16_gcn:
        print(f"  bf16 GCN ({smi}): " + json.dumps(rec))
    print(f"kernels (device ms per call: CUDA graphs of {GRAPH_CALLS} calls, "
          f"median of {TIMING_REPS} replays; call = one call from Python; "
          "bound at 3.35 TB/s, 67 TFLOP/s f32 FFMA, 989 TFLOP/s bf16 "
          "tensor cores):")
    launches = {"ragged_ell_spmm": counts["ragged_ell_spmm"],
                "bsr_spmm": counts["bsr_spmm"],
                "ell_spmm": {d: c["ell_spmm"] for d, c in ab_counts.items()},
                "tile_matmul": mm_counts["tile_matmul"]}
    kproblems, entries = kernel_phase(torch, engine, graphs, launches,
                                      mm_cases, log, REORDERED)
    problems += kproblems
    tb_problems, table_cases = table_phase(torch, log)
    problems += tb_problems
    for entry in entries:
        back = bwd_kernels.get(entry["name"])
        entry.update(backward_launches=bwd_launches[entry["name"]],
                     backward_ms=back[0]["ms"] if back else None,
                     backward_bound_ms=back[0]["bound_ms"] if back else None,
                     backward_library_ms=(back[0]["library_ms"] if back
                                          else None),
                     backward_cases=back)
        for v in back or ():
            print(f"  {entry['name'] + ' backward':16s} {v['graph']} F="
                  f"{v['F']}: kernel {v['ms']:.4f} ms  library "
                  f"{v['library_ms']:.4f} ms  bound {v['bound_ms']:.5f} ms "
                  f"({v['bound_by']})"
                  + (f"  launches {v['launches_per_call']} for "
                     f"{v['buckets']} buckets" if "buckets" in v else ""))
        if entry["name"] == "ragged_ell_spmm":
            entry["table_cases"] = table_cases
            entry["tuned"] = [dict(graph=r["graph"], f=r["f"],
                                   shape_class=r["shape_class"],
                                   config=r["winner"], ms=r["winner_ms"],
                                   default_ms=r["default_ms"])
                              for r in autotune]
    b16k_problems, bf16_entries = bf16_kernel_entries(
        torch, engine, graphs, bf16_launches, log)
    problems += b16k_problems
    entries += bf16_entries
    coo_problems, coo_entry = coo_phase(torch, engine, graphs,
                                        counts["coo_rows"], log)
    problems += coo_problems
    entries.append(coo_entry)
    gs_problems, gat_served = gat_served_phase(torch)
    problems += gs_problems
    print(f"gat served ({smi}): " + json.dumps(
        {k: v for k, v in gat_served.items() if k != "cases"}))
    gat_problems, gat_entry = gat_coef_phase(
        torch, log, launches={k: gat_served["launches"]["infer"][k]
                              for k in ("gat_row_stats", "gat_edge_coef")})
    problems += gat_problems
    entries.append(gat_entry)
    print(json.dumps({"e2e": e2e, "reordered": reordered,
                      "dispatch_ab": ab_rows, "lifecycle": lifecycle,
                      "xw": xw, "autotune": autotune,
                      "autotune_forward": tuned_forward, "lint": lint}))
    print(f"smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"serving": serving}))
    print(json.dumps({"train": train}))
    print(json.dumps({"lm": lm}))
    print(json.dumps({"fm": fm}))
    print(json.dumps({"geometric": geo}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"serving_tp": serving_tp}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"checkpoint": ckpt}))
    print(json.dumps({"bf16_gcn": bf16_gcn}))
    print(json.dumps({"kernels": entries}))
    if problems:
        for p in problems:
            print(f"chip_smoke: FAIL: {p}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
