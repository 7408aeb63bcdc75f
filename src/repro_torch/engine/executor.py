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
any size costs the launches of one graph per layer: one of each kernel,
with the ragged ELL dispatch or with "fused"/"loop" (one ``ell_spmm``
for every class band).

An autotuned ragged-kernel config, its launch shape and ``max_bands``
(``set_tuned``, fed by
``Engine.autotune``, one per class and feature width) rides in every
executor key of its class and is passed down the dispatch path as
``ell_tune``.
"""
from __future__ import annotations

import collections
import threading

from repro_torch.core.gat import gat_forward
from repro_torch.core.hybrid_spmm import (EVERY_WIDTH, gcn_forward,
                                         hybrid_spmm, tune_at)
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
        # Autotuned ragged-kernel configs, ShapeClass -> sorted item
        # tuple (hashable, so it can ride in executor keys).
        self._tuned: dict = {}

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

    # -------------------------------------------------------- autotune -----
    def set_tuned(self, sc: ShapeClass, cfg: dict, f: int = None) -> int:
        """Apply an autotuned ragged-kernel config (launch shape and
        ``max_bands``) to the executors of class ``sc``
        (``repro_torch.kernels.autotune`` winners land here).

        ``f`` is the feature width the config was tuned at: it then
        applies to the class's ragged launches of that width only
        (``Engine.autotune`` tunes each width on its own, so a layer runs
        the winner of its own width). ``f`` None applies ``cfg`` at every
        width and drops the per-width configs, the reference's one
        config per class. The configs ride in every executor key, so the
        class's cached executors are invalidated and the next lookup
        builds with ``ell_tune`` threaded down the dispatch path. Tuned
        and default outputs are bitwise-equal by kernel construction.
        Returns the number of executors invalidated; a no-op (same
        config already applied, or empty config on an untuned class)
        invalidates nothing.
        """
        with self._lock:
            table = dict(self._tuned.get(sc, ()))
            t = tuple(sorted(cfg.items()))
            if f is None:
                table = {EVERY_WIDTH: t} if t else {}
            elif t:
                table[int(f)] = t
            else:
                table.pop(int(f), None)
            new = tuple(sorted(table.items()))
            if self._tuned.get(sc, ()) == new:
                return 0
            if new:
                self._tuned[sc] = new
            else:
                self._tuned.pop(sc, None)
            return self.invalidate_class(sc)

    def tuned_for(self, sc: ShapeClass, f: int = None) -> dict:
        """The tuned config the class's ragged launches of width ``f``
        run ({} = defaults); ``f`` None: the one set for every width."""
        with self._lock:
            return tune_at(self._table(sc), f)

    def tuned(self) -> dict:
        """Every applied tuning, {ShapeClass: {width: config}}, width
        ``EVERY_WIDTH`` (0) for a config set for every width."""
        with self._lock:
            return {sc: self._table(sc) for sc in self._tuned}

    def _table(self, sc) -> dict:
        return {w: dict(t) for w, t in self._tuned.get(sc, ())}

    def _tune_of(self, sc):
        return self._tuned.get(sc, ())

    # ------------------------------------------------------------ spmm -----
    def spmm(self, sc: ShapeClass, f: int):
        """Executor for Y = A @ B over a padded partition of class sc.

        Signature: fn(part, b[n_cols_padded, f], plan) ->
        y[n_rows_padded, f].
        """
        with self._lock:
            key = ("spmm", sc, f, self.backend, self.ell_dispatch,
                   self._tune_of(sc))

            def build():
                meta = sc.to_meta()
                backend, dispatch, device = (self.backend, self.ell_dispatch,
                                             self.device)
                ell_tune = self.tuned_for(sc, f) or None

                def fn(part, b, plan):
                    return hybrid_spmm(part, b, meta=meta, backend=backend,
                                       ell_dispatch=dispatch, plan=plan,
                                       ell_tune=ell_tune, device=device)
                return fn
            return self._get(key, build)

    # ------------------------------------------------------------- gcn -----
    def _gcn_key(self, sc, f_in, w_shapes):
        return ("gcn", sc, f_in, w_shapes, self.backend, self.block_cols,
                self.ell_dispatch, self._tune_of(sc))

    def _gcn_build(self, sc):
        meta = sc.to_meta()
        backend, device = self.backend, self.device
        block_cols, dispatch = self.block_cols, self.ell_dispatch
        ell_tune = self._table(sc) or None

        def fwd(part, x, weights, plan, chain=None):
            return gcn_forward(part, x, weights, meta=meta, backend=backend,
                               block_cols=block_cols, ell_dispatch=dispatch,
                               plan=plan, ell_tune=ell_tune, device=device,
                               chain=chain)
        return fwd

    def gcn(self, sc: ShapeClass, f_in: int, w_shapes: tuple):
        """Executor for the 2+-layer GCN forward over one padded graph.

        Signature: fn(part, x[n_cols_padded, f_in], weights, plan,
        chain=None) -> logits[n_rows_padded, w_shapes[-1][-1]]; ``chain``
        is the caller's ``obs.device.DeviceChain`` for this call, so an
        executor built before a tracer was attached is timed once one
        is.
        """
        with self._lock:
            return self._get(self._gcn_key(sc, f_in, w_shapes),
                             lambda: self._gcn_build(sc))

    def gcn_batched(self, sc: ShapeClass, f_in: int, w_shapes: tuple,
                    batch: int):
        """GCN executor over a stacked class group of ``batch`` graphs:
        every partition leaf, ``x`` and the weights gain a leading group
        axis, and the plan covers the whole group."""
        with self._lock:
            key = self._gcn_key(sc, f_in, w_shapes) + ("batch", batch)
            return self._get(key, lambda: self._gcn_build(sc))

    # ------------------------------------------------------------- gat -----
    def _gat_key(self, sc, f_in, w_shapes, spec):
        return ("gat", sc, f_in, w_shapes, spec, self.backend)

    def _gat_build(self, sc, spec):
        meta = sc.to_meta()
        backend, device = self.backend, self.device

        def fwd(part, x, weights, plan, rows, chain=None):
            return gat_forward(part, x, weights, spec, meta=meta, plan=plan,
                               rows=rows, backend=backend, device=device,
                               chain=chain)
        return fwd

    def gat(self, sc: ShapeClass, f_in: int, w_shapes: tuple, spec):
        """Executor for the GAT forward (``core.gat.gat_forward``) over
        one padded graph of ``spec``'s structure.

        Signature: fn(part, x[n_cols_padded, f_in], weights, plan, rows,
        chain=None) -> logits[n_rows_padded, spec.out_width]; ``rows``
        the graph's placed ``RowLists``. The ELL engine runs the ragged
        dispatch at its default launch shape whatever the cache's
        dispatch and tuning."""
        with self._lock:
            return self._get(self._gat_key(sc, f_in, w_shapes, spec),
                             lambda: self._gat_build(sc, spec))

    def gat_batched(self, sc: ShapeClass, f_in: int, w_shapes: tuple, spec,
                    batch: int):
        """GAT executor over a stacked class group of ``batch`` graphs
        (leaves, ``x``, weights and the row lists stacked)."""
        with self._lock:
            key = self._gat_key(sc, f_in, w_shapes, spec) + ("batch", batch)
            return self._get(key, lambda: self._gat_build(sc, spec))

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
