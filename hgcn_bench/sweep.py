"""Find an open-loop cell's rate: one request's warm latency, the
deadline from it, and the knee of a sweep of Poisson rates.

    python -m hgcn_bench.sweep --workload reddit.online --seed 1 \
        --rates 20 30 40 50 60 70 80 --seconds 10

Sets the cell's configuration up once, then
- times one request served alone (``Engine.serve_group`` of one request
  and a synchronize, host clock, median of 20 after 5 warm ones);
- takes the deadline L as 10 times that, rounded up to 10 ms;
- for each rate, drives a fresh ``RequestQueue`` with the cell's mix at
  that rate and deadline L for ``--seconds`` after a warm-up, and prints
  p50, p95 (from each request's due time), the rate completed, and
  whether the backlog grew (the last quarter's median latency over the
  first quarter's, and requests still unresolved at the close).
The knee is the highest rate with p95 <= L and no growing backlog; the
cell's rate is 4/5 of it. Both go into the traffic file by hand. With
``--schedule-seeds`` it then drives the cell's rate (``--tail-rate``, or
4/5 of the knee) once for each of those gap sequences and each window
length in ``--lengths``, and prints p50 and p95 of each: how far the
tail of one fixed sequence stands for the rate, and how a longer window
moves it. The benchmark's runs never run this.

    python -m hgcn_bench.sweep --workload reddit.online --seed 1 \
        --rates 20 30 40 --schedule-seeds 0 1 2 3 4 --lengths 20 40
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

from hgcn_bench import yardstick
from hgcn_bench.spec import ROOT, resolve


def single_ms(sess) -> float:
    x = sess.pool[0]
    times = []
    for i in range(25):
        t0 = time.perf_counter()
        sess.engine.serve_group([(sess.name, x)])
        sess.torch.cuda.synchronize()
        if i >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def growth(win) -> float:
    """Median latency of the window's last quarter over its first's."""
    recs = sorted(win.counted(), key=lambda r: r["due"])
    q = max(len(recs) // 4, 1)

    def med(rs):
        return statistics.median(
            (r["done"] - r["due"]) if r["ok"] else math.inf for r in rs)
    return float(med(recs[-q:]) / med(recs[:q]))


def window(sess, cell, seed, seconds, **mix) -> dict:
    """One open-loop window of the cell's mix with ``mix`` changed:
    p50, p95, the rate completed and the backlog's growth."""
    from hgcn_bench import cell as cell_mod

    sess.traffic = dict(cell.traffic, **mix)
    q = sess.queue()
    try:
        win = cell_mod.open_loop(sess, q, seed, seconds,
                                 warmup_s=float(cell.traffic["warmup_s"]))
    finally:
        q.stop()
    lat = [((r["done"] - r["due"]) * 1e3 if r["ok"] else math.inf)
           for r in win.counted()]
    done = sum(1 for r in win.counted() if r["ok"]
               and r["done"] <= win.t_end)
    return {"requests": len(lat),
            "p50_ms": yardstick.percentile(lat, 50),
            "p95_ms": yardstick.percentile(lat, 95),
            "completed_per_s": done / win.seconds,
            "growth": growth(win),
            "late_ms_max": max(win.lateness) * 1e3}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--schedule-seeds", type=int, nargs="*", default=[])
    p.add_argument("--lengths", type=float, nargs="+", default=[20.0])
    p.add_argument("--tail-rate", type=float, default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from hgcn_bench import cell as cell_mod

    cell = resolve(args.workload)
    sess = cell_mod.Session(cell.config, cell.traffic, args.seed, "cuda")
    sess.warm()
    one = single_ms(sess)
    deadline = 10.0 * math.ceil(10.0 * one / 10.0)
    print(json.dumps({"single_request_ms": one, "deadline_ms": deadline}),
          flush=True)
    knee = None
    for rate in args.rates:
        row = {"rate_per_s": rate, **window(
            sess, cell, args.seed, args.seconds, rate_per_s=rate,
            deadline_ms=deadline)}
        ok = bool(row["p95_ms"] <= deadline and row["growth"] < 1.5)
        row["sustained"] = ok
        print(json.dumps(row), flush=True)
        if ok:
            knee = rate
    rate = args.tail_rate
    if rate is None and knee is not None:
        rate = 0.8 * knee
    print(json.dumps({"knee_per_s": knee, "deadline_ms": deadline,
                      "rate_per_s": rate}), flush=True)
    for seconds in args.lengths if rate is not None else ():
        for sched in args.schedule_seeds:
            row = window(sess, cell, args.seed, seconds, rate_per_s=rate,
                         deadline_ms=deadline, schedule_seed=sched)
            print(json.dumps({"tail": True, "rate_per_s": rate,
                              "seconds": seconds, "schedule_seed": sched,
                              **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
