"""Offline contract-checked autotuner for the ragged ELL kernel.

Port of ``repro.kernels.autotune``. Sweeps the ragged kernel's tunables
per (device, shape class, feature width) — its launch shape (lanes per
row ``w``, floats per lane ``vec``, K lanes in flight ``kc`` and
``threads`` per block, the instances ``csrc/ragged_ell_spmm.cu`` is
built with) and the K-band cap ``max_bands`` over ``SWEEP_MAX_BANDS``,
as the reference sweeps it — and caches the fastest *legal*
configuration on disk, keyed by the device, the tunable set and the
class signature, so a server process pays the sweep once per class
ever.

Legality comes first: every candidate's launch contract is audited by
the Hopper contract audit (``repro_torch.analysis.static.kernel_pass
.check_contract``) BEFORE any timing, and a candidate with an error
finding (an instance that is not built, ``kc > w``, a grid or 32-bit
extent out of range, an instance that spills in the recorded ptxas log)
is never run. Timing is injectable for deterministic tests; the default
timer measures device time with CUDA events over a replayed CUDA graph
of the tuned ``ragged_ell_rows`` launch on the rows of one registered
member of the class (``member_operands``). A card is required for it:
the plain version that runs on the CPU has no launch shape to time.

Every legal configuration is bitwise-equal to the default on finite B
(no launch knob changes a sum's order, and where a band stops a chain
past ``unit_k`` adds only zeros: ``csrc/ell_rows.cuh``), so the tuner
optimizes time only.

Consulted at dispatch: ``Engine.autotune`` feeds the winner to
``ExecutorCache.set_tuned``, which keys executors on the tuned config
and passes it down the dispatch path as ``ell_tune``.
"""
from __future__ import annotations

import itertools
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

from . import _build
from .bands import merge_bands
from .ell_spmm import (LAUNCH_KEYS, TUNE_KC, TUNE_KEYS, TUNE_THREADS,
                       TUNE_VEC, TUNE_W, ragged_ell_contract, resolve_tune)

# CUDA-graph replay of the default timer: launches per graph, and the
# graph's replays per candidate come from ``Autotuner.reps``.
GRAPH_CALLS = 20
# The K-band caps swept (the reference's ``SWEEP_MAX_BANDS``), the
# default first.
SWEEP_MAX_BANDS = (4, 1)


def candidates(f: int, bands: tuple = None) -> list:
    """The deduplicated candidate list for feature width ``f``: every
    launch shape with every cap of ``SWEEP_MAX_BANDS``.

    Knobs that are illegal at ``f`` clamp to their nearest legal value
    inside the contract (``vec`` 4 becomes 1 where ``f % 4 != 0``), and
    a cap at or above a class's band count leaves its plan as it is, so
    duplicates are dropped on the *effective* config: the clamped launch
    shape and, given the class's band plan ``bands``, the plan each cap
    merges it to (a class of one band times one candidate per launch
    shape); without ``bands``, the cap itself. The first candidate is
    the kernel's default configuration, so a tie on measured time keeps
    the default (ties broken by candidate order).
    """
    seen = set()
    out = []
    default = {k: v for k, v in resolve_tune(f).items() if k in LAUNCH_KEYS}
    for shape in itertools.chain([default], (
            dict(zip(LAUNCH_KEYS, v)) for v in itertools.product(
                TUNE_W, TUNE_VEC, TUNE_KC, TUNE_THREADS))):
        for mb in SWEEP_MAX_BANDS:
            cfg = dict(shape, max_bands=mb)
            eff = resolve_tune(f, cfg)
            eff = (tuple(eff[k] for k in LAUNCH_KEYS),
                   mb if bands is None else merge_bands(bands, mb))
            if eff in seen:
                continue
            seen.add(eff)
            out.append(cfg)
    return out


class AutotuneCache:
    """On-disk JSON cache of sweep winners.

    One flat dict {key: {"config": {...}, "ms": float}}; ``path=None``
    keeps it in memory only. Writes are atomic (tmp + rename) so a
    killed sweep never leaves a truncated cache. Invalidation is by key
    construction: the key embeds the device and the full class signature
    (including the band plan), so any class or device change misses
    instead of serving a stale winner.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mem: dict = {}
        if path and os.path.exists(path):
            try:
                with open(path) as fh:
                    self._mem = json.load(fh)
            except (OSError, ValueError):
                self._mem = {}   # unreadable cache == empty cache

    def __len__(self) -> int:
        return len(self._mem)

    def get(self, key: str) -> Optional[dict]:
        return self._mem.get(key)

    def put(self, key: str, entry: dict) -> None:
        self._mem[key] = entry
        if self.path:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self._mem, fh, indent=1, sort_keys=True)
            os.replace(tmp, self.path)


def class_stand_ins(sc) -> tuple:
    """Worst-case index stand-ins of one member of class ``sc``, as the
    contract audit takes them (``tile_col``, ``cols``, ``unit_k``): every
    unit on the LAST column tile, every lane on the last column of its
    tile, every unit at its band slot's full K."""
    u, r, kmax = sc.ell_units, sc.r_block, sc.ell_kmax
    tile_col = np.full((1, u), sc.n_col_tiles - 1, np.int32)
    cols = np.full((1, u, r, kmax), sc.tile - 1, np.int32)
    unit_k = np.repeat([k for k, _ in sc.bands],
                       [n for _, n in sc.bands]).astype(np.int32)[None]
    return tile_col, cols, unit_k


def member_operands(part, host_plan, sc, f: int, device, seed: int = 0
                    ) -> tuple:
    """The operands of one tuned ``ragged_ell_rows`` launch at a
    registered member of class ``sc``: its class-padded ELL leaf
    ``part.ell`` and the ELL part of its host plan ``host_plan``, with a
    group axis of 1, a seeded B of width ``f`` (the kernel's time does
    not depend on B's values) and the dense rows to add onto (zeros).
    Returns (cols, vals, tile_col, unit_k, b_tiles, plan, out) on
    ``device``."""
    from repro_torch.core.formats import plan_to, stack_plans
    dev = resolve_device(device)
    e = part.ell
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((1, sc.n_col_tiles, sc.tile, int(f)))
    plan = plan_to(stack_plans([host_plan]), dev).ell
    return (*(x[None].to(dev).contiguous() for x in (
                e.cols, e.vals, e.tile_col, e.unit_k)),
            torch.from_numpy(b.astype(np.float32)).to(dev),
            plan, torch.zeros((1, plan.lengths.shape[0], int(f)),
                              dtype=torch.float32, device=dev))


def device_seconds(fn, reps: int, calls: int = GRAPH_CALLS) -> float:
    """Device seconds of one call of ``fn``: ``calls`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events; the
    least replay over ``calls``. Replaying keeps the host out, so this
    is the time the card spends, not the enqueue."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # build / warm
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3 / calls)
    return best


class Autotuner:
    """Sweep -> contract audit -> time -> cache, per (class, width).

    ``timer`` (injectable) maps a candidate config dict (the tunables
    ``TUNE_KEYS``) to seconds; the default times the real kernel on the
    card (``device_seconds``) on a registered member's operands
    (``tune(..., operands=)``). Counters: ``hits``/``misses``
    (cache), ``swept`` (candidates considered), ``rejected`` (audit
    errors, never timed), ``timed``. ``last_sweep`` lists the last
    sweep's candidates: config, effective tunables, the number of bands
    the class runs at its cap, measured ms (None when rejected) and the
    audit's findings.
    """

    def __init__(self, cache_path: Optional[str] = None, *,
                 timer: Optional[Callable[[dict], float]] = None,
                 reps: int = 3, device="cuda"):
        self.cache = AutotuneCache(cache_path)
        self._timer = timer
        self.reps = max(1, int(reps))
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        self.backend = "cuda" if cuda else "cpu"
        self.device_name = (torch.cuda.get_device_name(self.device) if cuda
                            else "cpu")
        self.hits = 0
        self.misses = 0
        self.swept = 0
        self.rejected = 0
        self.timed = 0
        self.last_sweep: list = []
        # Optional repro_torch.obs tracer: `Engine.attach_tracer` fans it
        # out here so every sweep lands as an `autotune.sweep` instant on
        # the trace timeline. None = no tracing (the tuner is usable
        # without an engine).
        self.tracer = None

    # ------------------------------------------------------------ keys -----
    def cache_key(self, sc, f: int) -> str:
        """Device and the tunable set + full class signature (bands
        included) + width: a winner cached over another set of tunables
        (before ``max_bands`` was one) misses."""
        return (f"{self.backend}[{','.join(TUNE_KEYS)}]|{self.device_name}"
                f"|{sc.summary()}|f={int(f)}")

    # ----------------------------------------------------------- oracle -----
    def _audit(self, sc, f: int, cfg: dict) -> list:
        """Contract findings for one candidate (errors reject it).

        Builds the contract the tuned launch of one member would use
        (the candidate's launch shape and ``max_bands``, from ``cfg``: an
        illegal cap is the audit's to reject) and runs it through the
        contract audit with worst-case index stand-ins, the path
        ``repro_torch.analysis.static`` lints the defaults with. On a
        card the audit also reads the ptxas log of the built kernels
        (registers, spills).
        """
        from repro_torch.analysis.static.kernel_pass import check_contract
        c = ragged_ell_contract(1, sc.ell_units, sc.r_block, sc.ell_kmax,
                                sc.n_col_tiles, sc.tile, f,
                                segments=sc.bands, tune=cfg)
        return check_contract(c, scalar_args=class_stand_ins(sc))

    # ----------------------------------------------------------- timing -----
    def _measure(self, cfg: dict, data: tuple, segments: tuple) -> float:
        """Device seconds of one tuned ``ragged_ell_rows`` launch, with
        the class's K bands ``segments`` merged to the candidate's
        ``max_bands``."""
        from .ell_spmm import ragged_ell_rows
        cols, vals, tile_col, unit_k, b, plan, out = data
        return device_seconds(lambda: ragged_ell_rows(
            cols, vals, tile_col, unit_k, b, plan, out, segments=segments,
            max_bands=cfg.get("max_bands"), tune=cfg, device=self.device),
            self.reps)

    # ------------------------------------------------------------ sweep -----
    def tune(self, sc, f: int, *, operands: Optional[Callable] = None
             ) -> dict:
        """Winning config for (class, width): cached, else swept.

        ``operands`` makes, when the default timer first needs them, the
        tuned launch's operands at one registered member of ``sc``
        (``member_operands``; ``Engine.autotune`` passes them): the
        default timer times the kernel on a real member's rows, not on
        guessed ones. An injected ``timer`` needs none.

        Returns the tuned config dict ({} when the class has no ELL
        units or every candidate is illegal; callers then launch the
        defaults). A cache hit skips the sweep entirely.
        """
        if not sc.ell_units or not sc.ell_kmax:
            return {}
        key = self.cache_key(sc, f)
        tr = self.tracer
        cached = self.cache.get(key)
        if cached is not None:
            self.hits += 1
            if tr is not None and tr.enabled:
                tr.instant("autotune.sweep", "autotune",
                           args={"sclass": sc.summary(), "cached": True,
                                 "winner": dict(cached["config"])})
            return dict(cached["config"])
        if self._timer is None and self.device.type != "cuda":
            raise RuntimeError(
                "Autotuner: the default timer measures the kernel on a CUDA "
                "card; on the CPU pass timer=")
        if self._timer is None and operands is None:
            raise ValueError(
                "Autotuner: the default timer times a registered member's "
                "rows; pass operands= (Engine.autotune does) or timer=")
        self.misses += 1
        if self.backend == "cuda":
            _build.build_all()      # the audit reads the ptxas logs
        data = None
        best = None                            # (seconds, config)
        self.last_sweep = []
        for cfg in candidates(f, sc.bands):
            self.swept += 1
            findings = self._audit(sc, f, cfg)
            row = {"config": dict(cfg),
                   "effective": resolve_tune(f, cfg),
                   "bands": len(merge_bands(sc.bands, cfg["max_bands"])),
                   "ms": None, "findings": [x.render() for x in findings]}
            self.last_sweep.append(row)
            if any(x.severity == "error" for x in findings):
                self.rejected += 1             # illegal: NEVER timed
                continue
            if self._timer is not None:
                secs = float(self._timer(cfg))
            else:
                if data is None:
                    data = operands()
                secs = self._measure(cfg, data, sc.bands)
            row["ms"] = secs * 1e3
            self.timed += 1
            if best is None or secs < best[0]:  # strict: first min wins
                best = (secs, cfg)
        winner = {} if best is None else dict(best[1])
        self.cache.put(key, {"config": winner,
                             "ms": None if best is None else best[0] * 1e3})
        if tr is not None and tr.enabled:
            tr.instant("autotune.sweep", "autotune",
                       args={"sclass": sc.summary(), "cached": False,
                             "swept": self.swept, "winner": dict(winner)})
        return dict(winner)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "swept": self.swept, "rejected": self.rejected,
                "timed": self.timed, "cache_entries": len(self.cache)}
