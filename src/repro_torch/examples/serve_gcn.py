"""End-to-end async serving driver (the paper's kind: GCN *inference*).

The full production request path on the shape-class engine:

  offline  — graphs are registered once (reorder + tri-partition + pad
             into a canonical shape class) and executors are warmed.
  online   — a standing `RequestQueue` worker thread takes Poisson
             traffic: ``submit(name, x, deadline_ms)`` returns a future
             immediately; the scheduler accumulates per-class pending
             queues and closes a batch on pow2 target size or when the
             oldest request's deadline slack drops below the EWMA
             latency estimate, dispatching one launch per kernel per batch.

Reports the ServerStats telemetry block (occupancy, batch histogram,
latency percentiles, deadline misses) and engine cache counters.

Port of ``examples/serve_gcn.py``: the same driver over the port's
``Engine`` and ``RequestQueue``, on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_gcn [--requests 24]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.data.graphs import make_paper_dataset
from repro_torch.engine import Engine
from repro_torch.serving import LatencyModel, RequestQueue


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=2.0,
                    help="Poisson arrival rate (requests/s); paper-scale "
                         "pubmed serves ~1 batch/3s on CPU, so keep this "
                         "near capacity")
    ap.add_argument("--target-batch", type=int, default=4,
                    help="pow2 batch size the scheduler aims for")
    ap.add_argument("--deadline-ms", type=float, default=15000.0)
    ap.add_argument("--max-linger-ms", type=float, default=4000.0,
                    help="close a batch once its oldest member waited "
                         "this long, even with deadline slack left — "
                         "keeps latency bounded when dispatches queue "
                         "behind each other near capacity")
    ap.add_argument("--datasets", default="cora,citeseer,pubmed")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = Engine(device=args.device)
    rng = np.random.default_rng(0)
    feats = {}
    for name in args.datasets.split(","):
        csr, x, y, st = make_paper_dataset(name, scale=args.scale)
        weights = [
            (rng.standard_normal((st.n_features, args.hidden)) * 0.05
             ).astype(np.float32),
            (rng.standard_normal((args.hidden, st.n_classes)) * 0.05
             ).astype(np.float32)]
        h = engine.register(name, csr, reorder="labels",
                            labels=make_paper_dataset.last_labels,
                            weights=weights)
        feats[name] = x
        print(f"[offline] {name}: registered in {h.preprocess_s*1e3:.0f} ms — "
              f"{h.meta.summary()}")
        print(f"          class: {h.sclass.summary()}")

    # Warm every executor the scheduler can dispatch (single + pow2
    # batches) so no kernel build lands inside a request's deadline,
    # and PRIME the queue's EWMA latency model from warm re-runs — the
    # deadline rule then starts with real per-class estimates instead of
    # the conservative default.
    lat_model = LatencyModel()
    for name, x in feats.items():
        key = engine.group_key(name, x)
        bs = 1
        while True:
            engine.serve_group([(name, x)] * bs)              # warm up
            _wait(engine.device)
            t0 = time.monotonic()
            engine.serve_group([(name, x)] * bs)              # warm probe
            _wait(engine.device)
            lat_model.observe(key, bs, time.monotonic() - t0)
            if bs >= args.target_batch:
                break
            bs <<= 1
    print(f"[warmup] {engine.summary()}")

    # Online: the standing queue's worker thread owns batch closing;
    # this thread only submits on the Poisson schedule and collects
    # futures — exactly a frontend handler's view of the server.
    queue = RequestQueue(engine, target_batch=args.target_batch,
                         default_deadline_ms=args.deadline_ms,
                         max_linger_ms=args.max_linger_ms,
                         latency_model=lat_model).start()
    names = list(feats)
    futures = []
    t0 = time.monotonic()
    t_next = t0
    for _ in range(args.requests):
        t_next += float(rng.exponential(1.0 / args.rate))
        dt = t_next - time.monotonic()
        if dt > 0:
            time.sleep(dt)
        name = names[int(rng.integers(len(names)))]
        futures.append((name, queue.submit(name, feats[name] * rng.random())))
    outs = [(n, f.result(timeout=30.0)) for n, f in futures]
    queue.stop()
    wall = time.monotonic() - t0

    snap = queue.stats.snapshot()
    print(f"\nserved {snap['completed']} requests in {wall:.2f}s "
          f"({snap['completed'] / wall:.1f} req/s, arrival rate "
          f"{snap['arrival_rate_hz']:.0f}/s)")
    print(f"  occupancy: {snap['mean_batch']:.2f} requests/launch "
          f"(batch_hist={snap['batch_hist']}, "
          f"close_reasons={snap['close_reasons']})")
    print(f"  latency:   p50={snap['p50_ms']:.1f}ms p99={snap['p99_ms']:.1f}ms "
          f"deadline_misses={snap['deadline_misses']} "
          f"(deadline {args.deadline_ms:.0f}ms)")
    for name in names:
        n_out = sum(1 for n, y in outs if n == name)
        print(f"  {name:9s} answered {n_out} requests")
    print(engine.summary())
    return snap


if __name__ == "__main__":
    main()
