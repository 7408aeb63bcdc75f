"""Time the port's two ELL row kernels of one source tree at the shapes of
the graphs reordered by labels, for an A/B of two trees in one call.

    python3 scripts/ell_ab.py --src SRC --label NAME --out FILE.json
    python3 scripts/ell_ab.py --compare A.json B.json [...]

The first form needs a CUDA card. It imports ``repro_torch`` from SRC (a
tree's ``src`` directory), builds its kernels, registers cora and pubmed
at full size, reordered by their planted labels and in their natural
order, on an ``Engine`` (the paper's 2-layer GCN, hidden 128, seeded
Glorot weights) and, at each case, times one ``kernels.ops.ell_matmul``
call on the "ragged" and on the "fused" dispatch (the ragged kernel and
the fixed-K one, each with its sum onto rows and the add onto the dense
rows; ``--ragged-kc`` adds the ragged kernel tuned to other ``kc``) and
the library call that computes the same rows
(``torch.sparse.mm`` over a CSR of the ELL entries of the live rows,
then ``index_add_``): device ms a call, CUDA graphs of 20 calls, median
of 30 replays. Cases: each class-padded partition at layer 1's B (X·W1,
F = 128) and layer 2's (relu(X·W1)·W2, F = the class count), G = 1, and
G = 4 at cora@labels; and the partition of cora@labels that training
differentiates through (not padded to a class; cora is symmetric, so
its backward dB = Aᵀ·dY runs on it) at F = 128. It writes one JSON
object {"label", "gpu", "cases": [{case, dispatch, ms, launches,
library_ms, digest}]} to FILE and prints it; ``digest`` is a hash of the
output's bytes, the same on two trees that give the same bits.

The second form prints the cases of several such files side by side
(the median of each label's runs) and whether every tree gave the same
bits.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

import numpy as np

GRAPH_CALLS = 20
TIMING_REPS = 30
HIDDEN = 128
GROUP = 4
SEED = 0
DEVICE = "cuda"      # the card; a rehearsal of the control flow may set "cpu"


def device_ms(torch, fn) -> float:
    """Device time of one call: GRAPH_CALLS calls captured in one CUDA
    graph, replayed TIMING_REPS times; median per call."""
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


def glorot(rng, fan_in: int, fan_out: int) -> np.ndarray:
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)


def live_csr(torch, part, meta):
    """The ELL entries of the rows with an entry as a CSR over B's rows
    [G·N_pad, F] (masked lanes, sentinel rows and zero values dropped,
    duplicates summed), and those rows' ids over [G·P]."""
    cols, vals, rows, tcol, uk = (x.cpu().numpy() for x in part.ell)
    g, u, r, k = cols.shape
    t, nct, p = meta.tile, meta.n_col_tiles, meta.n_padded_rows
    rw = np.broadcast_to(rows[..., None], cols.shape)
    keep = ((np.arange(k) < uk[:, :, None, None])
            & (rw != meta.ell_sentinel_row) & (vals != 0))
    gi, ui, _, _ = np.nonzero(keep)
    row = gi * p + rw[keep]
    col = (gi * nct + tcol[gi, ui].astype(np.int64)) * t + cols[keep]
    live, pos = np.unique(row, return_inverse=True)
    m = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([pos, col])), torch.from_numpy(vals[keep]),
        (live.size, g * nct * t)).coalesce().to_sparse_csr()
    dev = part.ell.cols.device
    return (torch.sparse_csr_tensor(m.crow_indices().int(),
                                    m.col_indices().int(), m.values(),
                                    m.shape).to(dev),
            torch.from_numpy(live).to(dev))


def cases(torch):
    """(name, part, b, meta, plan) of every case, on the card."""
    from repro_torch.core import PartitionConfig, analyze_and_partition
    from repro_torch.core.formats import (TriPartition, partition_to,
                                          plan_to, reduction_plan,
                                          stack_plans)
    from repro_torch.core.reorder import reorder
    from repro_torch.data.graphs import make_paper_dataset
    from repro_torch.engine import Engine

    engine = Engine(device=DEVICE)
    rng = np.random.default_rng(SEED)
    for graph in ("cora", "pubmed"):
        csr, x, _, st = make_paper_dataset(graph, scale=1.0, seed=SEED)
        labels = make_paper_dataset.last_labels
        ws = [glorot(rng, st.n_features, HIDDEN),
              glorot(rng, HIDDEN, st.n_classes)]
        for name, kw in ((f"{graph}@labels", dict(reorder="labels",
                                                  labels=labels)),
                         (graph, {})):
            engine.register(name, csr, weights=ws, **kw)
            h = engine.handle(name)
            meta = h.sclass.to_meta()
            b1 = torch.matmul(engine.prepare_x(name, x), h.weights[0])
            b2 = torch.matmul(torch.relu(b1), h.weights[1])
            for b in (b1, b2):
                for g in ((1, GROUP) if name == "cora@labels" else (1,)):
                    part = TriPartition(*(type(c)(*(
                        torch.stack([a] * g).contiguous() for a in c))
                        for c in h.part))
                    plan = plan_to(stack_plans([h.host_plan] * g), DEVICE)
                    yield (dict(graph=name, F=int(b.shape[1]), G=g), part,
                           b[None].expand(g, -1, -1).contiguous(), meta,
                           plan)
        if graph == "cora":
            csr_l = reorder(csr, "labels", labels=labels)[0]
            part, meta, _ = analyze_and_partition(
                csr_l, PartitionConfig(tile=64))
            part = partition_to(part, DEVICE)
            part = TriPartition(*(type(c)(*(a[None] for a in c))
                                  for c in part))
            plan = reduction_plan(part, meta, device=DEVICE)
            gen = torch.Generator().manual_seed(SEED)
            b = torch.randn((1, meta.n_cols, HIDDEN), generator=gen).to(
                DEVICE)
            yield (dict(graph="cora@labels training partition",
                        F=HIDDEN, G=1, buckets=len(meta.ell_segments)),
                   part, b, meta, plan)


def measure(src: str, label: str, ragged_kc=()) -> dict:
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.kernels import _build, ops

    if not torch.cuda.is_available():
        sys.exit("ell_ab.py: no CUDA card")
    _build.build_all()
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = []
    for case, part, b, meta, plan in cases(torch):
        g, f = b.shape[0], b.shape[-1]
        yd = ops.dense_tiles_matmul(part, b, meta, plan)
        csr, live = live_csr(torch, part, meta)
        t, nct = meta.tile, meta.n_col_tiles
        bp = torch.nn.functional.pad(
            b, (0, 0, 0, nct * t - b.shape[1])).reshape(g * nct * t, f)
        lib_buf = yd.clone()
        library = device_ms(torch, lambda: lib_buf.view(-1, f).index_add_(
            0, live, torch.sparse.mm(csr, bp)))
        runs = [("ragged", None), ("fused", None)] + [
            (f"ragged kc={kc}", {"kc": kc}) for kc in ragged_kc]
        for d, tune in runs:
            dispatch = d.split()[0]
            kernel = "ragged_ell_spmm" if dispatch == "ragged" else "ell_spmm"
            c0 = ops.launch_counts()[kernel]
            got = ops.ell_matmul(part, b, meta, plan, yd.clone(),
                                 dispatch=dispatch, ell_tune=tune)
            torch.cuda.synchronize()
            launches = ops.launch_counts()[kernel] - c0
            buf = yd.clone()
            ms = device_ms(torch, lambda: ops.ell_matmul(
                part, b, meta, plan, buf, dispatch=dispatch, ell_tune=tune))
            out.append(dict(case, dispatch=d, ms=ms, launches=launches,
                            library_ms=library, digest=hashlib.sha256(
                                got.cpu().numpy().tobytes()).hexdigest()[:16]))
            print(json.dumps(out[-1]), flush=True)
    return dict(label=label, gpu=gpu, torch=torch.__version__, cases=out)


def compare(paths) -> None:
    runs = [json.load(open(p)) for p in paths]
    labels = list(dict.fromkeys(r["label"] for r in runs))
    print(f"gpu: {runs[0]['gpu']}; device ms a call (median of each "
          f"label's runs, then each run); labels {labels}")
    keys = list(dict.fromkeys(
        (json.dumps({k: v for k, v in c.items() if k in ("graph", "F", "G")}),
         c["dispatch"]) for r in runs for c in r["cases"]))
    for key in keys:
        row, digests, library, launches = {}, set(), [], {}
        for r in runs:
            for c in r["cases"]:
                ck = (json.dumps({k: v for k, v in c.items() if k in (
                    "graph", "F", "G")}), c["dispatch"])
                if ck == key:
                    row.setdefault(r["label"], []).append(c["ms"])
                    digests.add(c["digest"])
                    library.append(c["library_ms"])
                    launches[r["label"]] = c["launches"]
        cells = []
        for lab, v in row.items():
            each = ", ".join(f"{x:.5f}" for x in v)
            cells.append(f"{lab} {statistics.median(v):.5f} ({each}; "
                         f"{launches[lab]} launches)")
        print(f"{key[0]} {key[1]}: " + "  ".join(cells)
              + f"  library {statistics.median(library):.5f}  same bits "
              f"{len(digests) == 1}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", help="the tree's src directory")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs="+", metavar="JSON")
    ap.add_argument("--ragged-kc", nargs="*", type=int, default=[],
                    help="also time the ragged kernel tuned to these kc")
    args = ap.parse_args()
    if args.compare:
        compare(args.compare)
        return
    res = measure(args.src, args.label, args.ragged_kc)
    text = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)


if __name__ == "__main__":
    main()
