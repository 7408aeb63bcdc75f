"""Run one function on several local ranks, each its own process.

``run_ranks(fn, world_size, *args, backend="gloo", store_dir=...)``
starts ``world_size`` processes (the ``spawn`` start method: each
imports ``fn`` by its module path), joins them into one process group
through a file store under ``store_dir`` (no fixed port, so concurrent
runs do not collide), calls ``fn(rank, world_size, *args)`` in each and
returns the results in rank order. A rank that raises, or a run that
outlasts ``timeout_s``, fails the whole call and every process is
stopped. This is how the sharded layer runs across ranks on a machine
with one card: gloo process groups on the CPU.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import time
import traceback


def _rank_main(payload, rank, world_size, backend, store, timeout_s,
               results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                            # reported, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, *args, backend: str, store_dir: str,
              timeout_s: float = 120.0) -> list:
    """``[fn(0, n, *args), ..., fn(n - 1, n, *args)]``, each rank in its
    own process over one ``backend`` process group; raises
    ``RuntimeError`` with the first failing rank's traceback, or on
    timeout."""
    ctx = mp.get_context("spawn")
    stem = os.path.join(store_dir, f"run-{os.getpid()}-{time.time_ns()}")
    store, payload = stem + ".store", stem + ".args"
    # the function and its arguments are written once and read by every
    # rank: sent through each start pipe instead, a large argument holds
    # the next start until the previous rank has imported torch
    with open(payload, "wb") as f:
        pickle.dump((fn, args), f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(payload, r, world_size, backend, store,
                               timeout_s, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"run_ranks: {world_size - len(out)} of {world_size} "
                    f"ranks gave no result within {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: rank {dead[0]} exited "
                                       f"with {procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        # after a failure the other ranks may wait in a collective forever
        grace = 10.0 if len(out) == world_size else 0.0
        for p in procs:
            p.join(timeout=grace)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
