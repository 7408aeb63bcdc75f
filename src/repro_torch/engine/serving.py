"""The serving engine: offline registration, cached inference, batching.

Port of ``repro.engine.serving``. Request path:

  offline  — ``register``: reorder, tri-partition (Algorithms 1+2), pad
             into a shape class, build the reduction plan, and put the
             padded partition, plan and weights on the device once.
  online   — ``spmm`` / ``infer``: pad the request features, run the
             class's cached executor, slice + un-permute the output.
           — ``serve_batch``: group requests by (shape class, widths),
             then ``serve_group`` stacks each group and runs it with one
             launch of each kernel per layer.

``serve_group_async`` is the non-blocking core of ``serve_group``: it
stages and enqueues the device work (CUDA launches return before the
card finishes) and returns completion hooks backed by a CUDA event.

Not ported yet (later slices): replica views, the autotuner, the
lifecycle hooks, tracer/chaos attachment and the latency prior.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import (CSRMatrix, PartitionMeta,
                                      ReductionPlan, TriPartition,
                                      partition_to, plan_to, reduction_plan,
                                      stack_plans, to_numpy)
from repro_torch.core.hybrid_spmm import BACKENDS
from repro_torch.core.partition import PartitionConfig, analyze_and_partition
from repro_torch.core.reorder import reorder as reorder_csr
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import Counter, MetricsRegistry

from .executor import ExecutorCache
from .shape_class import (ClassNeed, ClassRegistry, ShapeClass, ShapePolicy,
                          class_requirements, pad_to_class)


@dataclasses.dataclass
class GraphHandle:
    """A registered graph: padded partition + the facts to undo padding."""

    name: str
    part: TriPartition          # padded to the class shapes, on the device
    meta: PartitionMeta         # original (true n_rows/n_cols/nnz)
    padded_meta: PartitionMeta  # the class's static meta + true nnz stats
    sclass: ShapeClass
    plan: ReductionPlan         # fixed-order reductions, on the device
    host_plan: ReductionPlan    # the same plan in numpy (for group stacks)
    perm: Optional[torch.Tensor]      # vertex reorder permutation, or None
    inv_perm: Optional[torch.Tensor]
    weights: Optional[list]     # per-graph GCN weights (tensors), or None
    preprocess_s: float = 0.0
    need: Optional[ClassNeed] = None

    @property
    def n_rows(self) -> int:
        return self.meta.n_rows


def _check_indices(part: TriPartition, meta: PartitionMeta) -> None:
    """Host check of the index ranges the CUDA kernels trust."""
    T = meta.tile
    checks = (
        ("dense.tile_col", part.dense.tile_col, meta.n_col_tiles),
        ("dense.tile_row", part.dense.tile_row, meta.n_row_tiles),
        ("ell.tile_col", part.ell.tile_col, meta.n_col_tiles),
        ("ell.cols", part.ell.cols, T),
        ("ell.rows", part.ell.rows, meta.ell_sentinel_row + 1),
        ("coo.rows", part.coo.rows, meta.n_padded_rows),
        ("coo.cols", part.coo.cols, meta.n_col_tiles * T),
    )
    for name, a, hi in checks:
        a = to_numpy(a)
        if a.size and (a.min() < 0 or a.max() >= hi):
            raise ValueError(f"partition index {name} out of range "
                             f"[0, {hi})")


class Engine:
    """Shape-class serving engine for the tri-hybrid SpMM/GCN.

    ``device`` defaults to ``"cuda"`` and raises without a card unless
    ``device="cpu"`` is given. ``backend="cuda"`` (the default) runs the
    hand-written kernels on CUDA tensors; ``backend="torch"`` runs the
    plain PyTorch versions (the reference's ``"xla"`` counterpart).
    """

    def __init__(self, *, policy: ShapePolicy = ShapePolicy(),
                 partition_cfg: PartitionConfig = PartitionConfig(tile=64),
                 backend: str = "cuda", block_cols: int = 0,
                 ell_dispatch: str = "ragged", executor_max_entries: int = 128,
                 max_stacks: int = 32, device="cuda"):
        self.device = resolve_device(device)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from "
                             f"{BACKENDS}")
        if ell_dispatch != "ragged":
            raise ValueError(
                f"ell dispatch {ell_dispatch!r} is not ported yet: only "
                "'ragged' runs here ('fused'/'loop' come in a later PR of "
                "the port)")
        if max_stacks < 1:
            raise ValueError(f"max_stacks must be >= 1, got {max_stacks}")
        self.policy = policy
        self.partition_cfg = partition_cfg
        self.registry = ClassRegistry(policy)
        self.executors = ExecutorCache(backend=backend, block_cols=block_cols,
                                       ell_dispatch=ell_dispatch,
                                       max_entries=executor_max_entries,
                                       device=self.device)
        self._graphs: dict = {}
        # serve_group member stacks (partition, weights, plan), keyed by
        # the canonicalized member-name tuple; bounded LRU. Re-registering
        # a name evicts its entries.
        self._stacks: collections.OrderedDict = collections.OrderedDict()
        self._max_stacks = max_stacks
        self._stack_lock = threading.Lock()
        self.metrics = MetricsRegistry()
        self._stack_hits = Counter("engine.stack_hits", self.metrics)
        self._stack_misses = Counter("engine.stack_misses", self.metrics)
        self._stack_evictions = Counter("engine.stack_evictions",
                                        self.metrics)

    @property
    def stack_hits(self) -> int:
        return self._stack_hits.value

    @property
    def stack_misses(self) -> int:
        return self._stack_misses.value

    @property
    def stack_evictions(self) -> int:
        return self._stack_evictions.value

    # --------------------------------------------------------- offline -----
    def register(self, name: str, csr: CSRMatrix, *,
                 reorder: Optional[str] = None, labels=None,
                 weights=None,
                 part_meta: Optional[tuple] = None) -> GraphHandle:
        """Preprocess one graph into its shape class.

        ``reorder`` names a ``repro_torch.core.reorder`` strategy (None
        skips). ``weights`` (list of [f_in, f_out] arrays) enables
        ``infer`` / ``serve_batch``. ``part_meta=(part, meta)`` skips
        partitioning for callers that already ran Algorithm 2.
        """
        t0 = time.perf_counter()
        perm = inv_perm = None
        if part_meta is not None:
            part, meta = part_meta
        else:
            if reorder is not None:
                kw = {"labels": labels} if reorder == "labels" else {}
                csr, perm, _ = reorder_csr(csr, reorder, **kw)
                inv = np.empty_like(perm)
                inv[perm] = np.arange(len(perm))
                inv_perm = torch.from_numpy(inv).to(self.device)
            part, meta, _ = analyze_and_partition(csr, self.partition_cfg)
        need = class_requirements(part, meta, self.policy)
        sc = self.registry.classify_need(need)
        padded, pmeta = pad_to_class(part, meta, sc)
        _check_indices(padded, pmeta)
        host_plan = reduction_plan(padded, pmeta)
        handle = GraphHandle(
            name=name, part=partition_to(padded, self.device), meta=meta,
            padded_meta=pmeta, sclass=sc,
            plan=plan_to(host_plan, self.device), host_plan=host_plan,
            perm=None if perm is None else torch.from_numpy(perm).to(
                self.device),
            inv_perm=inv_perm,
            weights=None if weights is None else [
                torch.as_tensor(np.asarray(to_numpy(w), np.float32)).to(
                    self.device) for w in weights],
            preprocess_s=time.perf_counter() - t0, need=need)
        self._graphs[name] = handle
        with self._stack_lock:
            self._stacks = collections.OrderedDict(
                (k, v) for k, v in self._stacks.items() if name not in k)
        return handle

    def handle(self, name: str) -> GraphHandle:
        return self._graphs[name]

    # ---------------------------------------------------------- online -----
    def _pad_x(self, h: GraphHandle, x) -> torch.Tensor:
        """Permute + zero-pad request features to the class input rows,
        on the device."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if x.shape[0] != h.meta.n_cols:
            raise ValueError(
                f"request features have {x.shape[0]} rows; graph "
                f"{h.name!r} expects {h.meta.n_cols}")
        if h.perm is not None:
            x = x[h.perm]
        want = h.sclass.n_col_tiles * h.sclass.tile
        if x.shape[0] != want:
            x = torch.nn.functional.pad(x, (0, 0, 0, want - x.shape[0]))
        return x

    def _unpad_y(self, h: GraphHandle, y) -> torch.Tensor:
        y = y[: h.n_rows]
        if h.inv_perm is not None:
            y = y[h.inv_perm]
        return y

    def spmm(self, name: str, b) -> torch.Tensor:
        """Y = A @ B through the cached shape-class executor."""
        h = self._graphs[name]
        fn = self.executors.spmm(h.sclass, int(b.shape[1]))
        return self._unpad_y(h, fn(h.part, self._pad_x(h, b), h.plan))

    def infer(self, name: str, x) -> torch.Tensor:
        """GCN forward logits for one request."""
        h = self._graphs[name]
        if h.weights is None:
            raise ValueError(f"graph {name!r} registered without weights")
        w_shapes = tuple(tuple(w.shape) for w in h.weights)
        fn = self.executors.gcn(h.sclass, int(x.shape[1]), w_shapes)
        return self._unpad_y(h, fn(h.part, self._pad_x(h, x), h.weights,
                                   h.plan))

    def _group_key(self, h: GraphHandle, x) -> tuple:
        if h.weights is None:
            raise ValueError(f"graph {h.name!r} registered without weights")
        w_shapes = tuple(tuple(w.shape) for w in h.weights)
        return (h.sclass, int(x.shape[1]), w_shapes)

    def group_key(self, name: str, x) -> tuple:
        """The (shape class, f_in, weight shapes) tuple that decides
        which requests may share one ``serve_group`` dispatch."""
        return self._group_key(self._graphs[name], x)

    def serve_batch(self, requests) -> list:
        """Serve [(name, x), ...]; returns logits in request order.

        Requests are grouped by (shape class, feature width, weight
        shapes); each group is dispatched through ``serve_group``.
        """
        groups: dict = {}
        for i, (name, x) in enumerate(requests):
            key = self._group_key(self._graphs[name], x)
            groups.setdefault(key, []).append((i, name, x))
        results: list = [None] * len(requests)
        for members in groups.values():
            ys = self.serve_group([(name, x) for _, name, x in members])
            for (i, _, _), y in zip(members, ys):
                results[i] = y
        return results

    def serve_group(self, requests) -> list:
        """One dispatch of a same-key group [(name, x), ...]: one launch
        of each kernel per layer, whatever the group size. Outputs
        return in request order (CUDA work may still be running; reading
        them synchronizes)."""
        return self.serve_group_async(requests)[0]

    def prepare_x(self, name: str, x) -> torch.Tensor:
        """Stage one request's features: permute + pad to the graph's
        class input rows on the device. Feeds ``serve_group_async``'s
        ``prepared`` argument."""
        return self._pad_x(self._graphs[name], x)

    def _stack(self, padded) -> tuple:
        """The cached (part, weights, plan) stack of a padded member list."""
        stack_key = tuple(h.name for _, h, _, _ in padded)
        with self._stack_lock:
            stacks = self._stacks.get(stack_key)
            if stacks is None:
                self._stack_misses.inc()
                hs = [h for _, h, _, _ in padded]
                part_stack = TriPartition(*(
                    type(comp)(*(torch.stack(leaves)
                                 for leaves in zip(*comps)))
                    for comp, comps in zip(hs[0].part,
                                           zip(*[h.part for h in hs]))))
                w_stack = [torch.stack(ws)
                           for ws in zip(*[h.weights for h in hs])]
                plan = plan_to(stack_plans([h.host_plan for h in hs]),
                               self.device)
                while len(self._stacks) >= self._max_stacks:
                    self._stacks.popitem(last=False)       # LRU out
                    self._stack_evictions.inc()
                stacks = self._stacks[stack_key] = (part_stack, w_stack,
                                                    plan)
            else:
                self._stacks.move_to_end(stack_key)        # mark MRU
                self._stack_hits.inc()
        return stacks

    def serve_group_async(self, requests, prepared=None) -> tuple:
        """Non-blocking ``serve_group``: stage + enqueue, don't wait.

        Returns ``(outs, meta)``: ``outs`` are the per-request outputs
        (their CUDA work may still be running) and ``meta`` is the
        completion contract:

          ``cold``        this dispatch built at least one executor;
          ``ready()``     True once the device finished the dispatch
                          (non-blocking poll of a CUDA event);
          ``complete()``  block until it finished.

        ``prepared`` optionally carries pre-staged padded features
        (``prepare_x``, aligned with ``requests``).
        """
        ex = self.executors
        if not requests:
            return [], {"cold": False, "ready": lambda: True,
                        "complete": lambda: None}
        members = []
        key0 = None
        for i, (name, x) in enumerate(requests):
            h = self._graphs[name]
            key = self._group_key(h, x)
            if key0 is None:
                key0 = key
            elif key != key0:
                raise ValueError(
                    f"serve_group members must share one (class, f_in, "
                    f"weight-shapes) key; {requests[0][0]!r} and {name!r} "
                    f"differ")
            xp = prepared[i] if prepared is not None else None
            members.append((i, h, x, xp))
        sc, f_in, w_shapes = key0
        misses0 = ex.stats.misses

        def pad(h, x, xp):
            return xp if xp is not None else self._pad_x(h, x)

        if len(members) == 1:
            i, h, x, xp = members[0]
            fn = ex.gcn(sc, f_in, w_shapes)
            outs = [self._unpad_y(h, fn(h.part, pad(h, x, xp), h.weights,
                                        h.plan))]
            return outs, self._completion_meta(misses0)
        # Canonicalize group order by name so (g0,g1) and (g1,g0) share
        # one cached stack, then pad to the next power-of-two group
        # (repeating the last member; its extra outputs are dropped).
        members.sort(key=lambda m: m[1].name)
        bs = 1 << (len(members) - 1).bit_length()
        padded = members + [members[-1]] * (bs - len(members))
        fn = ex.gcn_batched(sc, f_in, w_shapes, bs)
        part_stack, w_stack, plan = self._stack(padded)
        x_stack = torch.stack([pad(h, x, xp) for _, h, x, xp in padded])
        ys = fn(part_stack, x_stack, w_stack, plan)
        results: list = [None] * len(members)
        for j, (i, h, _, _) in enumerate(members):
            results[i] = self._unpad_y(h, ys[j])
        return results, self._completion_meta(misses0)

    def _completion_meta(self, misses0: int) -> dict:
        """Completion hooks for the work enqueued so far on the current
        stream (a CUDA event recorded after it), or trivially complete
        hooks on the CPU."""
        cold = self.executors.stats.misses > misses0
        if self.device.type != "cuda":
            return {"cold": cold, "ready": lambda: True,
                    "complete": lambda: None}
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return {"cold": cold, "ready": event.query,
                "complete": event.synchronize}

    # ----------------------------------------------------------- stats -----
    def stats(self) -> dict:
        classes = {h.sclass for h in self._graphs.values()}
        cache = self.executors.stats_snapshot()
        with self._stack_lock:
            stack = {"stacks": len(self._stacks),
                     "stack_hits": self.stack_hits,
                     "stack_misses": self.stack_misses,
                     "stack_evictions": self.stack_evictions}
        return {
            "graphs": len(self._graphs),
            "shape_classes": len(classes),
            "executors": self.executors.size,
            "executor_max_entries": self.executors.max_entries,
            "cache_hits": cache["hits"],
            "cache_misses": cache["misses"],
            "cache_evictions": cache["evictions"],
            "per_class": self.executors.class_stats(),
            "stack_max": self._max_stacks,
            "registry": self.registry.stats(),
            **stack,
        }

    def summary(self) -> str:
        s = self.stats()
        return (f"Engine: {s['graphs']} graphs in {s['shape_classes']} "
                f"shape classes on {self.device}; "
                f"{self.executors.summary()}")
