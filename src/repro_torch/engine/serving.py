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
card finishes) and returns completion hooks backed by a CUDA event. The
standing ``repro_torch.serving.RequestQueue`` forms groups from traffic
accumulated across calls and dispatches them through it; the queue
attaches itself (``attach_frontend``), its tracer (``attach_tracer``)
and its chaos injector (``attach_injector``), and seeds its latency
model from ``latency_prior``.

``replica_view(i)`` hands out a per-replica view with its own executor
cache over the shared graphs. The shape-class lifecycle
(``repro_torch.engine.lifecycle``) reads ``class_waste_by_class`` and
``class_traffic`` and acts through ``plan_retirement`` /
``execute_retirement``, which re-pads a retired class's members into
tighter classes and invalidates every executor cache.

Not ported yet (a later slice): the autotuner.
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
from repro_torch.kernels.ops import check_ell_dispatch
from repro_torch.obs.metrics import Counter, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.chaos import NULL_INJECTOR, InjectedFault

from .executor import ExecutorCache
from .lifecycle import RetirementPlan
from .shape_class import (ClassNeed, ClassRegistry, ShapeClass, ShapePolicy,
                          class_requirements, pad_to_class, unpad_from_class)


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


class _EngineReplicaView:
    """One replica's engine-facing view.

    Shares the owning engine's ``ClassRegistry``, registered graphs and
    stack cache, but owns a PRIVATE ``ExecutorCache`` on the engine's
    device: executors are per-replica state, so one replica's builds
    never invalidate or evict another's. Dispatches route through the
    engine's ``serve_group_async`` with this view's cache.
    """

    def __init__(self, engine: "Engine", replica_id: int, executors):
        self._engine = engine
        self.replica_id = replica_id
        self.executors = executors

    def group_key(self, name: str, x) -> tuple:
        return self._engine.group_key(name, x)

    def handle(self, name: str):
        return self._engine.handle(name)

    def latency_prior(self, key: tuple, batch: int):
        return self._engine.latency_prior(key, batch)

    def prepare_x(self, name: str, x):
        return self._engine.prepare_x(name, x)

    def serve_group_async(self, requests, prepared=None) -> tuple:
        return self._engine.serve_group_async(
            requests, prepared, executors=self.executors)

    def serve_group(self, requests) -> list:
        return self.serve_group_async(requests)[0]


class Engine:
    """Shape-class serving engine for the tri-hybrid SpMM/GCN.

    ``device`` defaults to ``"cuda"`` and raises without a card unless
    ``device="cpu"`` is given. ``backend="cuda"`` (the default) runs the
    hand-written kernels on CUDA tensors; ``backend="torch"`` runs the
    plain PyTorch versions (the reference's ``"xla"`` counterpart).
    ``ell_dispatch`` is ``"ragged"`` (one ``ragged_ell_spmm`` launch per
    layer) or one of the per-K A/B dispatches ``"fused"``/``"loop"``
    (one ``ell_spmm`` launch per class band per layer).
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
        check_ell_dispatch(ell_dispatch)
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
        # Request tracer (repro_torch.obs.trace): off by default; a
        # serving frontend constructed with `tracer=` calls
        # `attach_tracer`, which also fans the tracer out to the executor
        # caches so cache.hit/miss instants land in the same ring.
        self.tracer = NULL_TRACER
        # Chaos injector (repro_torch.serving.chaos): off by default; a
        # frontend constructed with `injector=` calls `attach_injector`,
        # which fans it out to the executor caches (the compile-failure
        # site). Sites owned here: "dispatch" (raise at enqueue),
        # "poison" (mark one member's name; outputs for poisoned names
        # come back non-finite), "hang" (completion meta never ready).
        self.injector = NULL_INJECTOR
        self._frontend = None   # attached repro_torch.serving.RequestQueue
        self._lifecycle = None  # attached LifecycleManager
        # Per-replica executor caches handed out by replica_view();
        # retirement invalidates a retired class in every one.
        self._replica_views: dict = {}
        self._replica_caches: list = []

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
        placed, plan, host_plan = self._place(padded, pmeta)
        handle = GraphHandle(
            name=name, part=placed, meta=meta, padded_meta=pmeta, sclass=sc,
            plan=plan, host_plan=host_plan,
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

    def _place(self, padded: TriPartition, pmeta: PartitionMeta) -> tuple:
        """Check a class-padded partition's indices, build its reduction
        plan on the host (with the per-K dispatches' band plans), and put
        both on the device.

        Returns (partition on the device, plan on the device, host plan).
        """
        _check_indices(padded, pmeta)
        host_plan = reduction_plan(padded, pmeta)
        return (partition_to(padded, self.device),
                plan_to(host_plan, self.device), host_plan)

    def handle(self, name: str) -> GraphHandle:
        return self._graphs[name]

    def replica_view(self, i: int) -> _EngineReplicaView:
        """The per-replica engine view of replica ``i``: shared registry
        and graphs, a private ``ExecutorCache`` on the engine's device
        with the engine's backend/dispatch configuration. Idempotent per
        index: a replica's cache survives re-wiring."""
        view = self._replica_views.get(i)
        if view is None:
            ex = self.executors
            cache = ExecutorCache(backend=ex.backend,
                                  block_cols=ex.block_cols,
                                  ell_dispatch=ex.ell_dispatch,
                                  max_entries=ex.max_entries,
                                  device=self.device)
            cache.tracer = self.tracer
            cache.injector = self.injector
            self._replica_caches.append(cache)
            view = self._replica_views[i] = _EngineReplicaView(
                self, i, cache)
        return view

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

    def serve_group_async(self, requests, prepared=None, *,
                          executors=None) -> tuple:
        """Non-blocking ``serve_group``: stage + enqueue, don't wait.

        Returns ``(outs, meta)``: ``outs`` are the per-request outputs
        (their CUDA work may still be running) and ``meta`` is the
        completion contract:

          ``cold``        this dispatch built at least one executor;
          ``ready()``     True once the device finished the dispatch
                          (non-blocking poll of a CUDA event);
          ``complete()``  block until it finished.

        ``prepared`` optionally carries pre-staged padded features
        (``prepare_x``, aligned with ``requests``). ``executors``
        substitutes a per-replica ``ExecutorCache`` (what
        ``replica_view`` dispatches through); None uses the engine's own.
        """
        ex = executors if executors is not None else self.executors
        if not requests:
            return [], {"cold": False, "ready": lambda: True,
                        "complete": lambda: None}
        inj = self.injector
        if inj.enabled:
            spec = inj.poll("dispatch")
            if spec is not None:
                raise InjectedFault("dispatch",
                                    transient=spec.mode == "transient")
            spec = inj.poll("poison")
            if spec is not None:
                inj.mark_poisoned(requests[spec.member % len(requests)][0])
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

        tr = self.tracer
        if len(members) == 1:
            i, h, x, xp = members[0]
            sp_pad = -1
            if tr.enabled:
                sp_pad = tr.begin("pad", "engine", args={"n": 1})
            fn = ex.gcn(sc, f_in, w_shapes)
            xpad = pad(h, x, xp)
            tr.end(sp_pad)
            outs = [self._unpad_y(h, fn(h.part, xpad, h.weights, h.plan))]
            meta = self._completion_meta(misses0, ex)
            if inj.enabled:
                outs, meta = self._inject_async(inj, requests, outs, meta)
            return outs, meta
        # Canonicalize group order by name so (g0,g1) and (g1,g0) share
        # one cached stack, then pad to the next power-of-two group
        # (repeating the last member; its extra outputs are dropped).
        members.sort(key=lambda m: m[1].name)
        bs = 1 << (len(members) - 1).bit_length()
        padded = members + [members[-1]] * (bs - len(members))
        sp_pad = -1
        if tr.enabled:
            sp_pad = tr.begin("pad", "engine",
                              args={"n": len(members), "batch": bs})
        fn = ex.gcn_batched(sc, f_in, w_shapes, bs)
        part_stack, w_stack, plan = self._stack(padded)
        x_stack = torch.stack([pad(h, x, xp) for _, h, x, xp in padded])
        tr.end(sp_pad)
        ys = fn(part_stack, x_stack, w_stack, plan)
        results: list = [None] * len(members)
        for j, (i, h, _, _) in enumerate(members):
            results[i] = self._unpad_y(h, ys[j])
        meta = self._completion_meta(misses0, ex)
        if inj.enabled:
            results, meta = self._inject_async(inj, requests, results, meta)
        return results, meta

    def _inject_async(self, inj, requests, outs, meta) -> tuple:
        """Apply post-enqueue chaos sites to one dispatch's results:
        poisoned member names yield non-finite outputs (multiplied by
        NaN on the device, every dispatch, so quarantine bisection can
        isolate them), and a fired "hang" spec makes the completion
        meta never ready — only the dispatch watchdog can reclaim the
        slot."""
        if inj.poisoned_names():
            outs = [y * float("nan") if inj.is_poisoned(nm) else y
                    for (nm, _), y in zip(requests, outs)]
        spec = inj.poll("hang")
        if spec is not None:
            def hung_complete():
                raise InjectedFault(
                    "hang", detail="completion forced on a hung dispatch")
            meta = dict(meta)
            meta["ready"] = lambda: False
            meta["complete"] = hung_complete
        return outs, meta

    def _completion_meta(self, misses0: int, ex: ExecutorCache) -> dict:
        """Completion hooks for the work enqueued so far on the current
        stream (a CUDA event recorded after it), or trivially complete
        hooks on the CPU. ``cold`` is the miss-counter delta of the cache
        ``ex`` that served the dispatch."""
        cold = ex.stats.misses > misses0
        if self.device.type != "cuda":
            return {"cold": cold, "ready": lambda: True,
                    "complete": lambda: None}
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return {"cold": cold, "ready": event.query,
                "complete": event.synchronize}

    # --------------------------------------------------------- latency -----
    def latency_prior(self, key: tuple, batch: int) -> Optional[float]:
        """Roofline-derived warm-latency prior for one group dispatch.

        Seeds the serving frontend's ``LatencyModel`` for keys with no
        observations yet: the class's padded MAC capacity (the slots the
        kernels *execute*, including masked lanes) and its array bytes
        give a FLOPs/bytes roofline bound at the H100 peaks in
        ``repro_torch.analysis.roofline``, floored at ``LAUNCH_FLOOR_S``
        so an arithmetic-light class never forecasts an implausibly
        instant dispatch (which would make the scheduler linger past its
        deadline). Returns None for keys whose class lacks capacity
        metadata (e.g. the simulation's stub classes) — the model then
        falls back to its flat default.
        """
        from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS
        sc = key[0]
        if not hasattr(sc, "ell_mac_capacity"):
            return None
        f_in = key[1]
        w_shapes = key[2] if len(key) > 2 else ()
        macs = (sc.ell_mac_capacity
                + sc.n_dense_tiles * sc.tile * sc.tile + sc.coo_nnz)
        n_rows = sc.n_row_tiles * sc.tile
        widths = [f_in] + [w[1] for w in w_shapes]
        # per layer: one hybrid SpMM at that width + the dense weight GEMM
        flops = 2.0 * macs * sum(widths)
        flops += sum(2.0 * n_rows * a * b for a, b in w_shapes)
        byts = 4.0 * (macs + n_rows * sum(widths))
        t = max(flops / PEAK_FLOPS, byts / HBM_BW) * max(int(batch), 1)
        return max(t, self.LAUNCH_FLOOR_S)

    # Floor for the roofline prior: per-dispatch launch and host overhead
    # that no capacity model predicts. The least warm one-request
    # `serve_group` wall time measured on the card with the features
    # already there, 1.14 ms (citeseer; cora and pubmed 1.22 and 1.15
    # ms), rounded down (NVIDIA H100 80GB HBM3, power limit 700 W;
    # chip_smoke.py's serving phase). A too-small first estimate closes
    # batches too late and misses deadlines.
    LAUNCH_FLOOR_S = 1.1e-3

    # ------------------------------------------------------ attachment -----
    def attach_tracer(self, tracer) -> None:
        """Install a ``repro_torch.obs.trace.Tracer`` and fan it out to
        the executor caches (the engine's and every replica view's) so
        engine-side spans and instants land in the same ring as the
        serving frontend's. ``RequestQueue(..., tracer=...)`` calls
        this; passing ``NULL_TRACER`` turns engine tracing back off."""
        self.tracer = tracer
        self.executors.tracer = tracer
        for cache in self._replica_caches:
            cache.tracer = tracer

    def attach_injector(self, injector) -> None:
        """Install a ``repro_torch.serving.chaos.ChaosInjector`` and fan
        it out to every executor cache (the compile-failure site lives
        in ``ExecutorCache._get``). Mirrors ``attach_tracer``; passing
        ``NULL_INJECTOR`` turns injection back off."""
        self.injector = injector
        self.executors.injector = injector
        for cache in self._replica_caches:
            cache.injector = injector

    def attach_frontend(self, frontend) -> None:
        """Register a serving frontend (``RequestQueue``) so its
        ``ServerStats`` surface through ``stats()["serving"]``. One
        frontend slot: attaching replaces the previous one, so a
        secondary queue over the same engine should pass
        ``RequestQueue(..., attach=False)``."""
        self._frontend = frontend

    # ------------------------------------------------------- lifecycle -----
    def class_waste_by_class(self) -> dict:
        """Per-shape-class padded-MAC waste, keyed by ShapeClass: members'
        true nnz against the class's padded capacity, per engine slice.

        ``ell_capacity`` counts the MAC slots of the class's band plan
        per member, so ``ell_waste_frac`` is the fraction of ELL kernel
        work spent on padding. The lifecycle manager retires a class
        whose rolling waste stays above its budget.
        """
        agg: dict = {}
        for h in self._graphs.values():
            d = agg.setdefault(h.sclass, {
                "members": 0, "ell_nnz": 0, "dense_nnz": 0, "coo_nnz": 0})
            d["members"] += 1
            d["ell_nnz"] += h.meta.nnz_ell
            d["dense_nnz"] += h.meta.nnz_dense
            d["coo_nnz"] += h.meta.nnz_coo
        out: dict = {}
        for sc, d in agg.items():
            m = d["members"]
            caps = {
                "ell_capacity": sc.ell_mac_capacity * m,
                "dense_capacity": sc.n_dense_tiles * sc.tile * sc.tile * m,
                "coo_capacity": sc.coo_nnz * m,
            }
            true_total = d["ell_nnz"] + d["dense_nnz"] + d["coo_nnz"]
            cap_total = sum(caps.values())
            entry = dict(d)
            entry.update(caps)
            entry["ell_waste_frac"] = (
                1.0 - d["ell_nnz"] / caps["ell_capacity"]
                if caps["ell_capacity"] else 0.0)
            entry["padded_mac_waste_frac"] = (
                1.0 - true_total / cap_total if cap_total else 0.0)
            out[sc] = entry
        return out

    def class_waste(self) -> dict:
        """``class_waste_by_class`` keyed by class summary strings (the
        ``stats()["class_waste"]`` block)."""
        return {sc.summary(): entry
                for sc, entry in self.class_waste_by_class().items()}

    def class_traffic(self) -> dict:
        """Cumulative executor lookups per ShapeClass, summed over the
        engine's own cache and every replica view's."""
        out = collections.Counter(self.executors.traffic_by_class())
        for cache in self._replica_caches:
            out.update(cache.traffic_by_class())
        return dict(out)

    def attach_lifecycle(self, manager) -> None:
        """Register a ``LifecycleManager`` so its counters surface through
        ``stats()["lifecycle"]``. One slot."""
        self._lifecycle = manager

    def members_of(self, sc: ShapeClass) -> list:
        """Names of every registered graph currently padded into ``sc``."""
        return [h.name for h in self._graphs.values() if h.sclass == sc]

    def plan_retirement(self, sc: ShapeClass) -> Optional[RetirementPlan]:
        """Plan (without mutating anything) the re-classing that retiring
        ``sc`` implies: members re-fit largest first, into surviving
        live classes or into tight classes founded for this plan.
        Returns None when ``sc`` has no members."""
        members = [h for h in self._graphs.values() if h.sclass == sc]
        if not members:
            return None
        members.sort(key=lambda h: (
            -(h.need.ell_kmax * h.need.ell_units * h.need.r_block
              + h.need.n_dense_tiles * h.need.tile * h.need.tile
              + h.need.coo_nnz),
            h.name))
        targets, new = self.registry.plan_reclass(
            [h.need for h in members], exclude=(sc,))
        return RetirementPlan(
            sclass=sc, names=tuple(h.name for h in members),
            targets=tuple(targets), new_classes=tuple(new))

    def execute_retirement(self, plan: RetirementPlan) -> dict:
        """Apply a ``RetirementPlan``: retire the class in the registry,
        re-pad every member into its successor class (partition and
        reduction plan placed on the device anew), invalidate the retired
        class's executors in the engine's cache and in every replica
        cache, and drop the member stacks that hold moved graphs.

        Callers serving live traffic must drain in-flight batches keyed
        on the retiring class first.
        """
        sc = plan.sclass
        self.registry.retire(sc)
        moved = []
        for name, target in zip(plan.names, plan.targets):
            h = self._graphs.get(name)
            if h is None or h.sclass != sc:
                continue    # re-registered since planning; already moved on
            self.registry.admit(target)
            part = unpad_from_class(h.part, h.padded_meta, h.meta)
            padded, pmeta = pad_to_class(part, h.meta, target)
            h.part, h.plan, h.host_plan = self._place(padded, pmeta)
            h.padded_meta = pmeta
            h.sclass = target
            moved.append(name)
        invalidated = self.executors.invalidate_class(sc)
        for cache in self._replica_caches:
            invalidated += cache.invalidate_class(sc)
        moved_set = set(moved)
        with self._stack_lock:
            self._stacks = collections.OrderedDict(
                (k, v) for k, v in self._stacks.items()
                if not moved_set.intersection(k))
        return {"members": len(moved),
                "executors_invalidated": invalidated,
                "new_classes": len(plan.new_classes)}

    # ----------------------------------------------------------- stats -----
    def stats(self) -> dict:
        classes = {h.sclass for h in self._graphs.values()}
        cache = self.executors.stats_snapshot()
        with self._stack_lock:
            stack = {"stacks": len(self._stacks),
                     "stack_hits": self.stack_hits,
                     "stack_misses": self.stack_misses,
                     "stack_evictions": self.stack_evictions}
        out = {
            "graphs": len(self._graphs),
            "shape_classes": len(classes),
            "executors": self.executors.size,
            "executor_max_entries": self.executors.max_entries,
            "cache_hits": cache["hits"],
            "cache_misses": cache["misses"],
            "cache_evictions": cache["evictions"],
            "per_class": self.executors.class_stats(),
            "stack_max": self._max_stacks,
            "class_waste": self.class_waste(),
            "registry": self.registry.stats(),
            **stack,
        }
        if self._frontend is not None:
            out["serving"] = self._frontend.stats.snapshot()
        if self._lifecycle is not None:
            out["lifecycle"] = self._lifecycle.snapshot()
        return out

    def summary(self) -> str:
        s = self.stats()
        return (f"Engine: {s['graphs']} graphs in {s['shape_classes']} "
                f"shape classes on {self.device}; "
                f"{self.executors.summary()}")
