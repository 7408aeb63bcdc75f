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
  5. dispatch A/B: the same requests through ``Engine(ell_dispatch=d)``
     for the per-K dispatches "fused" and "loop" (one ``ell_spmm`` launch
     per class band per layer, no ``ragged_ell_spmm``); "fused" logits
     must equal the ragged dispatch's bit for bit, "loop" within
     tolerance (bitwise equality printed), repeats bitwise;
  6. lifecycle, on the "ragged" and the "fused" dispatch: three
     pubmed-shaped graphs of one shape class, served, then their class
     retired by a ``LifecycleManager`` window; the successors are
     tighter and at least one has fewer padded rows (so X·W and the
     dense-tile grid run at a new M), ``spmm`` is bitwise-equal across
     the retirement, ``infer`` within tolerance (bitwise equality
     printed), and a replica view serves a successor class as the
     engine does;
  7. the matmul path: the GCN's X·W products of the main path through
     ``kernels.ops.matmul`` (the ``tile_matmul`` kernel);
  8. holds each of the four kernels against its plain PyTorch version at
     the shapes its path gave it, and times kernel, plain version and one
     library call (``torch.bmm``, ``torch.sparse.mm``, ``torch.matmul``)
     with CUDA events;
  9. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
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
TIMING_REPS = 30
GRAPH_CALLS = 20


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
        for kind in ("infer_launches", "group_launches"):
            if g[kind] != {"bsr_spmm": layers, "ragged_ell_spmm": layers,
                           "ell_spmm": 0, "tile_matmul": 0}:
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


# -------------------------------------------------------- dispatch A/B ----
def dispatch_ab(torch, graphs) -> tuple:
    """Serve the main path's requests through ``Engine(ell_dispatch=d)``
    for each per-K dispatch, with the launch counters set to 0 just
    before each dispatch's run and read just after.

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
            bands = len(engine.handle(name).sclass.bands)
            want = {"bsr_spmm": LAYERS, "ragged_ell_spmm": 0,
                    "ell_spmm": LAYERS * bands, "tile_matmul": 0}
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
            if d == "fused" and not bitwise:
                problems.append(f"fused {name}: logits not bitwise-equal to "
                                f"the ragged dispatch (max_abs_err {err})")
            if not all(close(a, b, **LOGIT_TOL) for a, b in pairs):
                problems.append(f"{d} {name}: logits vs ragged max_abs_err "
                                f"{err}")
            again = [engine.infer(name, g["xs"][0])] + engine.serve_group(
                [(name, x) for x in g["xs"]])
            if not all(torch.equal(a, b) for a, b in zip(again, [y] + ys)):
                problems.append(f"{d} {name}: repeat not bitwise-equal")
            x_dev = torch.from_numpy(g["xs"][0]).cuda()
            rows.append(dict(
                dispatch=d, graph=name, bands=bands,
                register_s=register_s[name],
                bitwise_vs_ragged=bitwise, max_abs_err_vs_ragged=err,
                infer_ms=wall_ms(torch, lambda: engine.infer(name,
                                                             g["xs"][0])),
                infer_dev_ms=wall_ms(torch, lambda: engine.infer(name,
                                                                 x_dev)),
                ragged_infer_ms=g["infer_ms"],
                ragged_infer_dev_ms=g["infer_dev_ms"]))
        if counts["ell_spmm"] == 0 or counts["ragged_ell_spmm"] != 0:
            problems.append(f"{d}: launches {counts}")
    return problems, rows, per_dispatch


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


# --------------------------------------------------------- kernel phase ----
def kernel_cases(torch, engine, graphs):
    """(graph, F, G, inputs, class meta) at the shapes the main path gave
    the sparse kernels: each graph's class-padded partition against B of
    width 128 (layer 1) and n_classes (layer 2), alone and stacked G=4."""
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
                                     h.part.ell.unit_k, h.part.ell.rows)]
                yield dict(graph=name, F=int(b.shape[1]), G=G), (part, bt,
                                                                 meta)


def bsr_case(torch, case):
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.ref import _gather_b_tiles, bsr_spmm_ref

    part, bt, _ = case
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


def unit_csr(torch, cols, vals, tcol, live, nct, t):
    """The unit array [G, U, R, K] as one CSR [G·U·R, G·nct·T] over the
    lanes ``live`` (built on the host, outside any timed region): its
    product with B tiles [G·nct·T, F] is the per-unit ELL product."""
    g, u, r, k = cols.shape
    c = cols.cpu().numpy().astype(np.int64)
    v = vals.cpu().numpy()
    keep = np.asarray(live) & (v != 0)
    gi, ui, ri, _ = np.nonzero(keep)
    tc = tcol.cpu().numpy().astype(np.int64)
    row = (gi * u + ui) * r + ri
    col = (gi * nct + tc[gi, ui]) * t + c[keep]
    coo = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([row, col])), torch.from_numpy(v[keep]),
        (g * u * r, g * nct * t), check_invariants=False).coalesce()
    return coo.to_sparse_csr().to(cols.device)


def ell_bytes(cols, tcol, live, t, f, g, u, r) -> float:
    """Bytes the ELL function must move: its cols/vals lanes, tile_col,
    each distinct B row its lanes ``live`` address, and the output."""
    live = np.broadcast_to(live, cols.shape)
    gid = np.broadcast_to(np.arange(g)[:, None, None, None], cols.shape)
    rows = (tcol.cpu().numpy()[:, :, None, None] * t + cols.cpu().numpy())
    used_rows = len(np.unique(gid[live] * (1 << 40) + rows[live]))
    return (cols.numel() * 8 + tcol.numel() * 4 + used_rows * f * 4
            + g * u * r * f * 4)


def ell_case(torch, case):
    from repro_torch.kernels.ell_spmm import ragged_ell_spmm
    from repro_torch.kernels.ref import ragged_ell_spmm_ref

    part, bt, _ = case
    cols, vals, tcol, uk = part[2:6]
    got = ragged_ell_spmm(cols, vals, tcol, uk, bt, device=bt.device)
    want = ragged_ell_spmm_ref(cols, vals, tcol, uk, bt)
    g, u, r, kmax = cols.shape
    nct, t, f = bt.shape[1:]
    live = (np.arange(kmax)[None, None, None, :]
            < uk.cpu().numpy()[:, :, None, None])          # [G,U,1,Kmax]
    live = np.broadcast_to(live, cols.shape)
    nbytes = ell_bytes(cols, tcol, live, t, f, g, u, r) + uk.numel() * 4
    flops = 2.0 * int(live.sum()) * f
    csr = unit_csr(torch, cols, vals, tcol, live, nct, t)
    b2 = bt.reshape(g * nct * t, f)
    return dict(
        ok=bool(torch.equal(got, want)), err=max_err(got, want),
        ms=device_ms(torch, lambda: ragged_ell_spmm(cols, vals, tcol, uk, bt,
                                                    device=bt.device)),
        call_ms=call_ms(torch, lambda: ragged_ell_spmm(cols, vals, tcol, uk,
                                                       bt, device=bt.device)),
        plain_ms=device_ms(torch, lambda: ragged_ell_spmm_ref(
            cols, vals, tcol, uk, bt)),
        library_ms=device_ms(torch, lambda: torch.sparse.mm(csr, b2)),
        bound=bound(nbytes, flops))


def fixed_ell_case(torch, case):
    """All buckets of one layer's ELL product, as the "fused"/"loop"
    dispatches launch them: one ``ell_spmm`` per class band, each writing
    its unit slice of one buffer."""
    from repro_torch.core.formats import RaggedEll, ell_buckets
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_spmm import ell_spmm
    from repro_torch.kernels.ref import ell_spmm_ref

    part, bt, meta = case
    cols, vals, tcol, uk, rows = part[2:7]
    buckets = ell_buckets(RaggedEll(cols, vals, rows, tcol, uk),
                          meta.ell_segments)
    g, u, r, kmax = cols.shape
    nct, t, f = bt.shape[1:]
    out = torch.empty((g, u, r, f), dtype=torch.float32, device=bt.device)

    def run():
        at = 0
        for bk in buckets:
            n = bk.cols.shape[-3]
            ell_spmm(bk.cols, bk.vals, bk.tile_col, bt,
                     out=out[:, at:at + n], device=bt.device)
            at += n
        return out

    def plain():
        return torch.cat([ell_spmm_ref(bk.cols, bk.vals, bk.tile_col, bt)
                          for bk in buckets], dim=1)

    c0 = ops.launch_counts()["ell_spmm"]
    got = run().clone()
    launches_per_call = ops.launch_counts()["ell_spmm"] - c0
    want = plain()
    # lanes the fixed-K function reads: kk < K of each unit's bucket
    kk_of = np.concatenate([np.full(bk.cols.shape[-3], bk.cols.shape[-1])
                            for bk in buckets])
    live = np.broadcast_to(np.arange(kmax)[None, None, None, :]
                           < kk_of[None, :, None, None], cols.shape)
    lanes = int(live.sum())
    nbytes = (ell_bytes(cols, tcol, live, t, f, g, u, r)
              - cols.numel() * 8 + lanes * 8)     # only the K-wide slabs
    flops = 2.0 * lanes * f
    csr = unit_csr(torch, cols, vals, tcol, live, nct, t)
    b2 = bt.reshape(g * nct * t, f)
    return dict(
        ok=bool(torch.equal(got, want)), err=max_err(got, want),
        launches_per_call=launches_per_call, ms=device_ms(torch, run),
        call_ms=call_ms(torch, run), plain_ms=device_ms(torch, plain),
        library_ms=device_ms(torch, lambda: torch.sparse.mm(csr, b2)),
        bound=bound(nbytes, flops))


def matmul_case(torch, case):
    from repro_torch.kernels.ref import tile_matmul_ref
    from repro_torch.kernels.tile_matmul import tile_matmul

    a, b = case
    got = tile_matmul(a, b, device=a.device)
    want = tile_matmul_ref(a, b)
    m, k = a.shape
    n = b.shape[1]
    return dict(
        ok=matmul_close(torch, got, want, a, b), err=max_err(got, want),
        ms=device_ms(torch, lambda: tile_matmul(a, b, device=a.device)),
        call_ms=call_ms(torch, lambda: tile_matmul(a, b, device=a.device)),
        plain_ms=device_ms(torch, lambda: tile_matmul_ref(a, b)),
        library_ms=device_ms(torch, lambda: torch.matmul(a, b)),
        bound=bound(4.0 * (m * k + k * n + m * n), 2.0 * m * k * n))


KERNELS = (
    ("ragged_ell_spmm", "src/repro_torch/kernels/csrc/ragged_ell_spmm.cu",
     "src/repro/kernels/ell_spmm.py:433", ell_case, "sparse"),
    ("bsr_spmm", "src/repro_torch/kernels/csrc/bsr_spmm.cu",
     "src/repro/kernels/bsr_spmm.py:28", bsr_case, "sparse"),
    ("ell_spmm", "src/repro_torch/kernels/csrc/ell_spmm.cu",
     "src/repro/kernels/ell_spmm.py:322", fixed_ell_case, "sparse"),
    ("tile_matmul", "src/repro_torch/kernels/csrc/tile_matmul.cu",
     "src/repro/kernels/tile_matmul.py:66", matmul_case, "matmul"),
)


def kernel_phase(torch, engine, graphs, launches, matmul_cases) -> tuple:
    """Hold each kernel against its plain version at every shape its path
    gave it, and time it. ``launches`` maps each kernel to the count of
    its path's run, or to {path: count} for a kernel of several paths
    (``launches`` is then the first path's count)."""
    problems, entries = [], []
    cases = {"sparse": list(kernel_cases(torch, engine, graphs)),
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
            if "launches_per_call" in res:
                row["launches_per_call"] = res["launches_per_call"]
            rows.append(row)
            print(f"  {kname:16s} {json.dumps(label):52s} kernel "
                  f"{res['ms']:.4f} ms (call {res['call_ms']:.4f})  plain "
                  f"{res['plain_ms']:.4f} ms  library "
                  f"{res['library_ms']:.4f} ms  bound "
                  f"{res['bound'][0]:.5f} ms "
                  f"({res['bound'][1]})  max_abs_err {res['err']:.3g}")
            if not res["ok"]:
                problems.append(f"{kname} {label}: disagrees with its plain "
                                f"version ({res['err']})")
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
        ptxas = [ln.strip() for ln in entry["log"].splitlines()
                 if "registers" in ln or "bytes smem" in ln]
        print(f"  {name}: {'cached' if entry['cached'] else 'built'}"
              f"{'; ' if ptxas else ''}{' | '.join(ptxas)}")

    engine, graphs, counts = main_path(torch)
    print(f"main path launches: {counts}")
    problems = check_main_path(torch, engine, graphs, counts)

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
    launches = {"ragged_ell_spmm": counts["ragged_ell_spmm"],
                "bsr_spmm": counts["bsr_spmm"],
                "ell_spmm": {d: c["ell_spmm"] for d, c in ab_counts.items()},
                "tile_matmul": mm_counts["tile_matmul"]}
    kproblems, entries = kernel_phase(torch, engine, graphs, launches,
                                      mm_cases)
    problems += kproblems
    print(json.dumps({"e2e": e2e, "dispatch_ab": ab_rows,
                      "lifecycle": lifecycle}))
    print(f"smoke: {time.perf_counter() - t_start:.1f} s")
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
