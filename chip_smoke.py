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
  4. checks every dispatch: logits finite and of the right shape, within
     tolerance of the port's plain "torch" backend on the same card,
     ``serve_group`` outputs matching per-request ``infer``, repeat runs
     bitwise-equal, and exactly one launch of each kernel per layer;
  5. holds each kernel against its plain PyTorch version at the shapes
     the main path gave it, and times kernel, plain version and (for the
     BSR kernel) one library call with CUDA events;
  6. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
     "device": ...}`` line.

Any failed check exits non-zero without the last line. Without CUDA, or
without the repository's sources, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): device memory rate and
# float32 outside the tensor cores (the kernels run FFMA, no TF32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# The paper's model, as in src/repro/configs/gcn_paper.py CONFIG:
# 2-layer GCN, hidden 128; the output width is the dataset's n_classes.
HIDDEN = 128
GRAPHS = ("cora", "citeseer", "pubmed")
GROUP = 4
SEED = 0

KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)   # f32, one k order vs another
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)    # 1433-wide X·W, other sum order
TIMING_REPS = 30
GRAPH_CALLS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def max_err(a, b) -> float:
    return float((a - b).abs().max().item()) if a.numel() else 0.0


def close(a, b, rtol, atol) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all().item())


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


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops,
                                                          "operations")


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
    layers = 2
    for name, g in graphs.items():
        ref.register(name, g["csr"], weights=g["ws"])
        want_shape = (g["n"], g["classes"])
        outs = [g["y_infer"]] + list(g["y_group"])
        for y in outs:
            if tuple(y.shape) != want_shape:
                problems.append(f"{name}: logits shape {tuple(y.shape)}")
            if not bool(torch.isfinite(y).all()):
                problems.append(f"{name}: non-finite logits")
        for kind in ("infer_launches", "group_launches"):
            if g[kind] != {"bsr_spmm": layers, "ragged_ell_spmm": layers}:
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
        if not all(close(a, b, **LOGIT_TOL)
                   for a, b in zip(g["y_group"], solo)):
            problems.append(f"{name}: serve_group vs infer max_abs_err "
                            f"{g['err_group_vs_infer']}")
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
    for k in ("bsr_spmm", "ragged_ell_spmm"):
        if counts[k] == 0:
            problems.append(f"{k} never launched on the main path")
    return problems


def profile_infer(torch, engine, name, x_dev, calls: int = 5) -> dict:
    """Device time of one ``infer`` with features on the card, from a
    ``torch.profiler`` trace of ``calls`` calls: kernels per call, device
    ms per call, the device's busy share of the traced wall time, and the
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.infer(name, x_dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            engine.infer(name, x_dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            launches += 1
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
    busy_us = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    return dict(kernels_per_infer=launches / calls,
                device_ms_per_infer=busy_us / calls / 1e3,
                busy_share=busy_us / wall_us if wall_us else 0.0,
                top=[[k[:60], v / calls / 1e3] for k, v in top])


# --------------------------------------------------------- kernel phase ----
def kernel_cases(torch, engine, graphs):
    """(graph, F, G, inputs) at the shapes the main path gave each kernel:
    each graph's class-padded partition against B of width 128 (layer 1)
    and n_classes (layer 2), alone and stacked G=4."""
    from repro_torch.core.formats import b_tiles_of

    for name, g in graphs.items():
        h = engine.handle(name)
        meta = h.sclass.to_meta()
        b1 = torch.matmul(engine.prepare_x(name, g["xs"][0]), h.weights[0])
        # layer 2's B is relu(A·B1)·W2; relu(B1)·W2 has its shape and scale
        b2 = torch.matmul(torch.relu(b1), h.weights[1])
        for b in (b1, b2):
            for G in (1, GROUP):
                bt = b_tiles_of(b[None].expand(G, -1, -1),
                                meta).contiguous()
                part = [torch.stack([leaf] * G).contiguous()
                        for leaf in (h.part.dense.tiles,
                                     h.part.dense.tile_col, h.part.ell.cols,
                                     h.part.ell.vals, h.part.ell.tile_col,
                                     h.part.ell.unit_k)]
                yield name, int(b.shape[1]), G, part, bt


def bsr_case(torch, part, bt):
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.ref import _gather_b_tiles, bsr_spmm_ref

    tiles, tcol = part[0], part[1]
    got = bsr_spmm(tiles, tcol, bt, device=bt.device)
    want = bsr_spmm_ref(tiles, tcol, bt)
    gathered = _gather_b_tiles(bt, tcol)
    g, n_t, t, _ = tiles.shape
    f = bt.shape[-1]
    tc = tcol.cpu().numpy()
    used_b = sum(len(np.unique(tc[i])) for i in range(g)) * t * f * 4
    nbytes = tiles.numel() * 4 + tcol.numel() * 4 + used_b + g * n_t * t * f * 4
    flops = 2.0 * g * n_t * t * t * f
    return dict(
        ok=close(got, want, **KERNEL_TOL), err=max_err(got, want),
        ms=device_ms(torch, lambda: bsr_spmm(tiles, tcol, bt,
                                              device=bt.device)),
        call_ms=call_ms(torch, lambda: bsr_spmm(tiles, tcol, bt,
                                                device=bt.device)),
        plain_ms=device_ms(torch, lambda: bsr_spmm_ref(tiles, tcol, bt)),
        library_ms=device_ms(torch, lambda: torch.bmm(
            tiles.reshape(g * n_t, t, t), gathered.reshape(g * n_t, t, f))),
        bound=bound(nbytes, flops))


def ell_case(torch, part, bt):
    from repro_torch.kernels.ell_spmm import ragged_ell_spmm
    from repro_torch.kernels.ref import ragged_ell_spmm_ref

    cols, vals, tcol, uk = part[2:]
    got = ragged_ell_spmm(cols, vals, tcol, uk, bt, device=bt.device)
    want = ragged_ell_spmm_ref(cols, vals, tcol, uk, bt)
    g, u, r, kmax = cols.shape
    f = bt.shape[-1]
    t = bt.shape[-2]
    live = (np.arange(kmax)[None, None, None, :]
            < uk.cpu().numpy()[:, :, None, None])          # [G,U,1,Kmax]
    live = np.broadcast_to(live, cols.shape)
    gid = np.broadcast_to(np.arange(g)[:, None, None, None], cols.shape)
    rows = (tcol.cpu().numpy()[:, :, None, None] * t + cols.cpu().numpy())
    used_rows = len(np.unique(gid[live] * (1 << 40) + rows[live]))
    nbytes = (cols.numel() * 8 + tcol.numel() * 8 + used_rows * f * 4
              + g * u * r * f * 4)
    flops = 2.0 * int(live.sum()) * f
    return dict(
        ok=bool(torch.equal(got, want)), err=max_err(got, want),
        ms=device_ms(torch, lambda: ragged_ell_spmm(cols, vals, tcol, uk, bt,
                                                    device=bt.device)),
        call_ms=call_ms(torch, lambda: ragged_ell_spmm(cols, vals, tcol, uk,
                                                       bt, device=bt.device)),
        plain_ms=device_ms(torch, lambda: ragged_ell_spmm_ref(
            cols, vals, tcol, uk, bt)),
        library_ms=None, bound=bound(nbytes, flops))


KERNELS = (
    ("ragged_ell_spmm", "src/repro_torch/kernels/csrc/ragged_ell_spmm.cu",
     "src/repro/kernels/ell_spmm.py:433", ell_case),
    ("bsr_spmm", "src/repro_torch/kernels/csrc/bsr_spmm.cu",
     "src/repro/kernels/bsr_spmm.py:28", bsr_case),
)


def kernel_phase(torch, engine, graphs, counts) -> tuple:
    problems, entries = [], []
    cases = list(kernel_cases(torch, engine, graphs))
    for kname, source, replaces, run in KERNELS:
        rows = []
        for gname, f, G, part, bt in cases:
            res = run(torch, part, bt)
            rows.append(dict(graph=gname, F=f, G=G, ms=res["ms"],
                             call_ms=res["call_ms"],
                             plain_ms=res["plain_ms"],
                             library_ms=res["library_ms"],
                             bound_ms=res["bound"][0],
                             bound_by=res["bound"][1],
                             max_abs_err=res["err"]))
            print(f"  {kname:16s} {gname:9s} F={f:<4d} G={G} "
                  f"kernel {res['ms']:.4f} ms (call {res['call_ms']:.4f})  "
                  f"plain {res['plain_ms']:.4f} ms  library "
                  f"{res['library_ms']} ms  bound "
                  f"{res['bound'][0]:.5f} ms ({res['bound'][1]})  "
                  f"max_abs_err {res['err']:.3g}")
            if not res["ok"]:
                problems.append(f"{kname} {gname} F={f} G={G}: disagrees "
                                f"with its plain version ({res['err']})")
        head = rows[0]   # cora, F=128, G=1: the first dispatch's layer 1
        entries.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=counts[kname],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            shape=f"{head['graph']} class, F={head['F']}, G={head['G']}",
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

    t0 = time.perf_counter()
    log = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(log)} sources")
    for name, entry in sorted(log.items()):
        ptxas = [ln.strip() for ln in entry["log"].splitlines()
                 if "registers" in ln or "bytes smem" in ln]
        print(f"  {name}: {'cached' if entry['cached'] else 'built'}"
              f"{'; ' if ptxas else ''}{' | '.join(ptxas)}")

    engine, graphs, counts = main_path(torch)
    print(f"main path launches: {counts}")
    problems = check_main_path(torch, engine, graphs, counts)
    e2e = []
    for name, g in graphs.items():
        h = engine.handle(name)
        prof = profile_infer(torch, engine, name,
                             torch.from_numpy(g["xs"][0]).cuda())
        row = dict(graph=name, n=g["n"], register_s=g["register_s"],
                   infer_ms=g["infer_ms"], infer_dev_ms=g["infer_dev_ms"],
                   group4_ms=g["group_ms"],
                   err_vs_torch=g["err_vs_torch"],
                   err_group_vs_infer=g["err_group_vs_infer"],
                   group_bitwise_infer=g["group_bitwise_infer"],
                   shape_class=h.sclass.summary(), profile=prof)
        e2e.append(row)
        print(f"  {name}: " + json.dumps(row))
    print(f"kernels (device ms per call: CUDA graphs of {GRAPH_CALLS} calls, "
          f"median of {TIMING_REPS} replays; call = one call from Python; "
          "bound at 3.35 TB/s, 67 TFLOP/s f32):")
    kproblems, entries = kernel_phase(torch, engine, graphs, counts)
    problems += kproblems
    print(json.dumps({"e2e": e2e}))
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
