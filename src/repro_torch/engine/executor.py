"""Bounded LRU cache of built executors over shape classes.

Port of ``repro.engine.executor``. One executor per (kind, shape class,
feature widths, backend, dispatch knobs); every graph padded into the
same class reuses it. PyTorch runs eagerly, so an "executor" is a built
eager callable closed over the class's ``PartitionMeta`` — there is no
trace or compile to amortize yet (CUDA-graph capture of the class-shaped
forward is a later PR of the port). The cache keeps the reference's
keys, LRU bound and per-class telemetry so that the serving layers
above it see the same behaviour.

The batched variant runs the same forward over a leading group axis
``G``: every CUDA kernel takes ``G`` as a grid dimension, so a group of
any size costs the launches of one graph per layer (one of each kernel
with the ragged ELL dispatch; one ``ell_spmm`` per class band with
"fused"/"loop").
"""
from __future__ import annotations

import collections
import threading

from repro_torch.core.hybrid_spmm import gcn_forward, hybrid_spmm
from repro_torch.kernels.ops import check_ell_dispatch
from repro_torch.obs.metrics import Counter, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.chaos import NULL_INJECTOR, InjectedFault

from .shape_class import ShapeClass


class CacheStats:
    """Executor-cache telemetry on ``repro_torch.obs.metrics`` counters,
    with the reference's read-only integer attribute surface."""

    def __init__(self, prefix: str = "cache", registry=None):
        self._hits = Counter(prefix + ".hits", registry)
        self._misses = Counter(prefix + ".misses", registry)
        self._evictions = Counter(prefix + ".evictions", registry)
        self._invalidations = Counter(prefix + ".invalidations", registry)

    def inc_hits(self, n: int = 1) -> None:
        self._hits.inc(n)

    def inc_misses(self, n: int = 1) -> None:
        self._misses.inc(n)

    def inc_evictions(self, n: int = 1) -> None:
        self._evictions.inc(n)

    def inc_invalidations(self, n: int = 1) -> None:
        self._invalidations.inc(n)

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    @property
    def invalidations(self) -> int:
        return self._invalidations.value

    @property
    def total(self) -> int:
        return self.hits + self.misses

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations}


class ExecutorCache:
    """Eager executors keyed by (kind, shape class, widths, backend...).

    Every key's second element is the ShapeClass, which is how the
    per-class telemetry attributes hits/misses/evictions.
    """

    def __init__(self, backend: str = "cuda", block_cols: int = 0,
                 ell_dispatch: str = "ragged", max_entries: int = 128,
                 device="cuda"):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        check_ell_dispatch(ell_dispatch)
        self.backend = backend
        self.block_cols = block_cols
        self.ell_dispatch = ell_dispatch
        self.max_entries = max_entries
        self.device = device
        self._fns: collections.OrderedDict = collections.OrderedDict()
        self.metrics = MetricsRegistry()
        self.stats = CacheStats("cache", self.metrics)
        self._class_stats: dict = {}   # ShapeClass -> CacheStats
        # Observability hook (repro_torch.obs): cache.hit/cache.miss
        # instant events. Off by default; `Engine.attach_tracer` swaps
        # it in.
        self.tracer = NULL_TRACER
        # Chaos hook (repro_torch.serving.chaos): the "compile" injection
        # site lives in the `_get` miss path. `Engine.attach_injector`
        # swaps a live injector in; NULL_INJECTOR keeps the path
        # zero-cost.
        self.injector = NULL_INJECTOR
        # Guards _fns/_class_stats bookkeeping: pipelined staging workers
        # look executors up concurrently with user-thread infer()/spmm()
        # calls. build() runs inside the lock so one cold key builds
        # once and the miss counter (the frontend's cold-sample
        # detector) stays coherent.
        self._lock = threading.RLock()

    def _per_class(self, sc: ShapeClass) -> CacheStats:
        st = self._class_stats.get(sc)
        if st is None:
            st = self._class_stats[sc] = CacheStats("cache.class")
        return st

    def _get(self, key, build):
        tr = self.tracer
        with self._lock:
            cls = self._per_class(key[1])
            fn = self._fns.get(key)
            if fn is None:
                self.stats.inc_misses()
                cls.inc_misses()
                if tr.enabled:
                    tr.instant("cache.miss", "engine",
                               args={"kind": key[0]})
                inj = self.injector
                if inj.enabled and inj.poll("compile") is not None:
                    # injected build failure: the build never ran, so
                    # the next lookup misses again and a retry rebuilds
                    # (transient by construction)
                    raise InjectedFault(
                        "compile", detail=f"executor build for {key[0]}")
                fn = build()
                self._fns[key] = fn
                while len(self._fns) > self.max_entries:
                    old_key, _ = self._fns.popitem(last=False)   # LRU out
                    self.stats.inc_evictions()
                    self._per_class(old_key[1]).inc_evictions()
            else:
                self._fns.move_to_end(key)                       # mark MRU
                self.stats.inc_hits()
                cls.inc_hits()
                if tr.enabled:
                    tr.instant("cache.hit", "engine",
                               args={"kind": key[0]})
            return fn

    def __len__(self) -> int:
        with self._lock:
            return len(self._fns)

    @property
    def size(self) -> int:
        """Number of live executors."""
        with self._lock:
            return len(self._fns)

    def stats_snapshot(self) -> dict:
        """Coherent copy of the global hit/miss/evict counters."""
        with self._lock:
            return self.stats.as_dict()

    def class_stats(self) -> dict:
        """Per-shape-class telemetry: {summary str: hit/miss/evict dict}."""
        with self._lock:
            return {sc.summary(): st.as_dict()
                    for sc, st in self._class_stats.items()}

    def traffic_by_class(self) -> dict:
        """Cumulative executor lookups (hits + misses) per ShapeClass:
        the lifecycle manager's traffic gate (a class with no lookups in
        a window ran no kernels, so retiring it buys nothing)."""
        with self._lock:
            return {sc: st.total for sc, st in self._class_stats.items()}

    def invalidate_class(self, sc: ShapeClass) -> int:
        """Drop every cached executor keyed on ``sc``; counted apart from
        LRU evictions. Returns the number of executors dropped."""
        with self._lock:
            dead = [key for key in self._fns if key[1] == sc]
            for key in dead:
                del self._fns[key]
            if dead:
                self.stats.inc_invalidations(len(dead))
                self._per_class(sc).inc_invalidations(len(dead))
            return len(dead)

    # ------------------------------------------------------------ spmm -----
    def spmm(self, sc: ShapeClass, f: int):
        """Executor for Y = A @ B over a padded partition of class sc.

        Signature: fn(part, b[n_cols_padded, f], plan) ->
        y[n_rows_padded, f].
        """
        key = ("spmm", sc, f, self.backend, self.ell_dispatch)

        def build():
            meta = sc.to_meta()
            backend, dispatch, device = (self.backend, self.ell_dispatch,
                                         self.device)

            def fn(part, b, plan):
                return hybrid_spmm(part, b, meta=meta, backend=backend,
                                   ell_dispatch=dispatch, plan=plan,
                                   device=device)
            return fn
        return self._get(key, build)

    # ------------------------------------------------------------- gcn -----
    def _gcn_key(self, sc, f_in, w_shapes):
        return ("gcn", sc, f_in, w_shapes, self.backend, self.block_cols,
                self.ell_dispatch)

    def _gcn_build(self, sc):
        meta = sc.to_meta()
        backend, device = self.backend, self.device
        block_cols, dispatch = self.block_cols, self.ell_dispatch

        def fwd(part, x, weights, plan):
            return gcn_forward(part, x, weights, meta=meta, backend=backend,
                               block_cols=block_cols, ell_dispatch=dispatch,
                               plan=plan, device=device)
        return fwd

    def gcn(self, sc: ShapeClass, f_in: int, w_shapes: tuple):
        """Executor for the 2+-layer GCN forward over one padded graph.

        Signature: fn(part, x[n_cols_padded, f_in], weights, plan) ->
        logits[n_rows_padded, w_shapes[-1][-1]].
        """
        return self._get(self._gcn_key(sc, f_in, w_shapes),
                         lambda: self._gcn_build(sc))

    def gcn_batched(self, sc: ShapeClass, f_in: int, w_shapes: tuple,
                    batch: int):
        """GCN executor over a stacked class group of ``batch`` graphs:
        every partition leaf, ``x`` and the weights gain a leading group
        axis, and the plan covers the whole group."""
        key = self._gcn_key(sc, f_in, w_shapes) + ("batch", batch)
        return self._get(key, lambda: self._gcn_build(sc))

    def summary(self) -> str:
        with self._lock:
            kinds: dict = {}
            for key in self._fns:
                kinds[key[0]] = kinds.get(key[0], 0) + 1
            return (f"ExecutorCache backend={self.backend} "
                    f"executors={len(self._fns)}/{self.max_entries} "
                    f"({kinds}) "
                    f"hits={self.stats.hits} misses={self.stats.misses} "
                    f"evictions={self.stats.evictions}")
