"""Density-aware shape-class lifecycle: waste-budget retirement and
recompile-on-drift.

Port of ``repro.engine.lifecycle``, copied whole: the policy uses the
standard library only, so the port keeps its own copy rather than
importing the reference. The algorithm, knobs and counters are the
reference's.

The class registry grows classes monotonically, so as the serving mix
drifts (yesterday's big graphs stop arriving, today's smaller cousins
keep padding into yesterday's oversized classes), the padded-MAC waste
in ``Engine.stats()["class_waste"]`` climbs with nothing acting on it.
`LifecycleManager` closes that loop. Each call to ``step()`` is one
**evaluation window**:

  1. **observe** — fold every live class's ``padded_mac_waste_frac``
     into a per-class EWMA, and measure the window's executor traffic
     (hits + misses) per class.
  2. **hysteresis** — a class becomes a retirement candidate only after
     its *rolling* waste exceeds ``waste_budget`` for ``breach_windows``
     consecutive windows AND it saw at least ``min_traffic`` executor
     lookups this window. With ``traffic_weight`` and the gate on, the
     waste compared against the budget is scaled by the class's
     dispatch share relative to the window's hottest class. Successor
     classes are immune for ``cooldown_windows`` windows after founding.
  3. **budget** — candidates are ranked by rolling waste; at most
     ``max_retires_per_window`` classes retire per window, and a
     retirement is skipped (not queued) if the tight re-classing plan
     would found more new classes than the remaining
     ``max_recompiles_per_window`` budget allows.
  4. **timing** — with a serving frontend that offers
     ``retirement_lull``, an approved retirement waits for a queue lull
     for up to ``max_defer_windows`` windows (skip reason
     ``"deferred"``).
  5. **retire** — the engine plans the re-classing
     (``Engine.plan_retirement``), a frontend with ``drain_class``
     drains in-flight batches keyed on the retiring class first, and
     the engine executes the plan (``Engine.execute_retirement``:
     re-pad members, invalidate the retired class's executors). With no
     frontend the plan executes directly.

The manager is engine-agnostic: it needs only ``class_waste_by_class``
/ ``class_traffic`` / ``plan_retirement`` / ``execute_retirement``.
Its counters land in ``Engine.stats()["lifecycle"]`` once attached.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RetirementPlan:
    """One retirement, fully decided before anything mutates.

    ``targets[i]`` is the successor class for member ``names[i]``;
    ``new_classes`` lists the targets that do not exist yet (each costs
    at most one executor compile per op signature on its first use —
    the quantity the lifecycle budget bounds).
    """

    sclass: object            # the retiring class
    names: tuple              # member graph names, re-pad order
    targets: tuple            # successor class per member (aligned)
    new_classes: tuple        # targets that must be founded

    @property
    def n_new_classes(self) -> int:
        return len(self.new_classes)


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Knobs of the retirement policy (see module docstring for the
    algorithm they parameterize).

    waste_budget
        Rolling ``padded_mac_waste_frac`` above which a class breaches.
        0.5 means "more than half the padded MAC slots this class makes
        its members execute are zeros".
    breach_windows
        Consecutive breaching windows required before retirement — the
        hysteresis that keeps transient traffic from churning classes.
    min_traffic
        Executor lookups (hits + misses) a class needs *in the window*
        to be retirement-eligible; 0 disables the traffic gate (and the
        traffic weighting with it — a traffic-blind policy, used by
        offline drift benchmarks). An idle class wastes no kernel time,
        so retiring it spends recompile budget for nothing.
    traffic_weight
        When True (default) and the traffic gate is on, the waste
        compared against ``waste_budget`` is ``ewma_waste × (class
        dispatches / hottest class's dispatches)`` this window — the
        hottest class is judged on its full waste, a class running 10%
        of the hot path's traffic must waste ~10× the budget before it
        outranks it. (Relative, not absolute, share: absolute shares
        would discount every class once traffic spreads and no budget
        would ever trip.) False restores the unweighted comparison.
    max_defer_windows
        Windows an approved retirement may be deferred waiting for a
        queue lull (no pending member of the class within its
        deadline-close horizon). 0 retires immediately regardless of
        queue state.
    min_members
        Classes with fewer registered members are left alone.
    cooldown_windows
        Windows a freshly-founded successor class is immune, so one
        retirement can't cascade into re-retiring its own successors.
    max_retires_per_window
        Hard cap on classes retired per window.
    max_recompiles_per_window
        Hard cap on *new classes founded* by retirements per window
        (the recompile budget). A plan that would overshoot is skipped
        this window, not truncated mid-retirement.
    ewma_alpha
        Smoothing of the rolling waste signal (1.0 = no smoothing).
    """

    waste_budget: float = 0.5
    breach_windows: int = 2
    min_traffic: int = 1
    min_members: int = 1
    cooldown_windows: int = 2
    max_retires_per_window: int = 1
    max_recompiles_per_window: int = 4
    ewma_alpha: float = 0.5
    traffic_weight: bool = True
    max_defer_windows: int = 2

    def __post_init__(self):
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], "
                             f"got {self.ewma_alpha}")
        if not 0.0 <= self.waste_budget < 1.0:
            raise ValueError(f"waste_budget must be in [0, 1), "
                             f"got {self.waste_budget}")
        if self.breach_windows < 1:
            raise ValueError("breach_windows must be >= 1")
        if self.max_defer_windows < 0:
            raise ValueError("max_defer_windows must be >= 0")


@dataclasses.dataclass
class _ClassTrack:
    """Rolling per-class lifecycle state between windows."""

    ewma_waste: Optional[float] = None
    breaches: int = 0
    windows: int = 0
    cooldown: int = 0
    last_traffic: int = 0     # cumulative lookups at last window end
    weighted_waste: float = 0.0   # last window's budget-compared value
    defers: int = 0           # consecutive lull-deferred retirements


class LifecycleManager:
    """The class lifecycle policy loop; one instance per Engine.

    ``step()`` evaluates one window. The caller owns the cadence —
    a serving loop calls it every N seconds, the drift benchmark calls
    it between traffic phases, the simulation calls it on virtual time.
    Attaching (default) surfaces ``snapshot()`` through
    ``Engine.stats()["lifecycle"]``.
    """

    def __init__(self, engine, frontend=None,
                 config: LifecycleConfig = LifecycleConfig(), *,
                 attach: bool = True):
        self.engine = engine
        self._frontend = frontend
        self.config = config
        self._tracks: dict = {}
        # cumulative counters
        self.windows = 0
        self.retires = 0
        self.reclassed_members = 0
        self.recompiles = 0          # new classes founded by retirement
        self.executors_invalidated = 0
        self.drained_batches = 0
        self.skipped: dict = {}      # reason -> count
        self.last_window: dict = {}
        if attach:
            attach_fn = getattr(engine, "attach_lifecycle", None)
            if attach_fn is not None:
                attach_fn(self)

    @property
    def frontend(self):
        """The serving frontend drained before invalidation — explicit
        if one was passed, else whatever is attached to the engine at
        step time (so construction order doesn't matter)."""
        if self._frontend is not None:
            return self._frontend
        return getattr(self.engine, "_frontend", None)

    # ------------------------------------------------------------ window ----
    def _observe(self, waste: dict, traffic: dict) -> dict:
        """Fold one window of telemetry into the per-class tracks.

        Returns {sclass: window traffic delta}. Tracks for classes that
        vanished (retired, or all members re-registered away) are
        dropped so the state dict can't grow without bound.
        """
        cfg = self.config
        deltas: dict = {}
        # first pass: EWMAs + window traffic deltas (the weighting
        # needs the window's TOTAL dispatches before any breach call)
        for sc, entry in waste.items():
            t = self._tracks.get(sc)
            if t is None:
                t = self._tracks[sc] = _ClassTrack()
            w = float(entry["padded_mac_waste_frac"])
            t.windows += 1
            t.ewma_waste = (w if t.ewma_waste is None else
                            (1 - cfg.ewma_alpha) * t.ewma_waste
                            + cfg.ewma_alpha * w)
            cum = int(traffic.get(sc, 0))
            deltas[sc] = cum - t.last_traffic
            t.last_traffic = cum
        max_delta = max(deltas.values(), default=0)
        weighting = (cfg.traffic_weight and cfg.min_traffic > 0
                     and max_delta > 0)
        for sc, entry in waste.items():
            t = self._tracks[sc]
            # dispatch share RELATIVE to the window's hottest class: the
            # hot path is judged on its raw waste (factor 1.0), colder
            # classes are discounted by how much less they run. An
            # absolute share would discount everyone once traffic
            # spreads over a few classes and no budget would ever trip.
            t.weighted_waste = (t.ewma_waste * deltas[sc] / max_delta
                                if weighting else t.ewma_waste)
            if t.cooldown > 0:
                t.cooldown -= 1
                t.breaches = 0
            elif (t.weighted_waste > cfg.waste_budget
                  and int(entry["members"]) >= cfg.min_members
                  and (cfg.min_traffic == 0
                       or deltas[sc] >= cfg.min_traffic)):
                t.breaches += 1
            else:
                t.breaches = 0
                t.defers = 0
        for sc in [sc for sc in self._tracks if sc not in waste]:
            del self._tracks[sc]
        return deltas

    def step(self) -> dict:
        """Evaluate one window; retire what the policy says to retire.

        Returns the window report (also kept as ``last_window``):
        ``retired`` (list of retired-class summaries), ``reclassed`` /
        ``recompiles`` / ``drained_batches`` counts, ``skipped``
        ({reason: count} for candidates the budgets deferred), and
        ``breaching`` (classes currently accumulating hysteresis).
        """
        cfg = self.config
        self.windows += 1
        waste = self.engine.class_waste_by_class()
        traffic = self.engine.class_traffic()
        self._observe(waste, traffic)

        candidates = sorted(
            (sc for sc, t in self._tracks.items()
             if t.breaches >= cfg.breach_windows),
            key=lambda sc: (-self._tracks[sc].weighted_waste,
                            self._summary(sc)))
        window = {"window": self.windows, "retired": [], "reclassed": 0,
                  "recompiles": 0, "drained_batches": 0, "skipped": {},
                  "breaching": sum(1 for t in self._tracks.values()
                                   if t.breaches > 0)}

        # An engine-attached tracer, where the engine has one: retirements
        # and skips show up as instant events on the trace timeline.
        # `getattr` keeps the manager engine-agnostic (the port's Engine
        # has no tracer yet).
        tracer = getattr(self.engine, "tracer", None)

        def skip(reason):
            window["skipped"][reason] = window["skipped"].get(reason, 0) + 1
            self.skipped[reason] = self.skipped.get(reason, 0) + 1
            if tracer is not None and tracer.enabled:
                tracer.instant("lifecycle.skip", "lifecycle",
                               args={"reason": reason})

        lull = getattr(self.frontend, "retirement_lull", None)
        for sc in candidates:
            if len(window["retired"]) >= cfg.max_retires_per_window:
                skip("retire_budget")
                continue
            plan = self.engine.plan_retirement(sc)
            if plan is None or not plan.names:
                continue
            if all(t == sc for t in plan.targets):
                # The tight re-found IS the retired class (granule/cap
                # floors saturated): the waste is structural, not drift.
                # Retiring would invalidate live executors, recompile
                # them identically, and re-breach forever. Back off
                # with a cooldown instead of churning.
                skip("no_tighter")
                self._tracks[sc].breaches = 0
                self._tracks[sc].cooldown = cfg.cooldown_windows
                continue
            if (window["recompiles"] + plan.n_new_classes
                    > cfg.max_recompiles_per_window):
                skip("recompile_budget")
                continue
            track = self._tracks[sc]
            if (lull is not None and cfg.max_defer_windows > 0
                    and track.defers < cfg.max_defer_windows
                    and not lull(sc)):
                # deadline-aware timing, checked LAST so only a
                # retirement that would otherwise run right now burns
                # defer budget (a no_tighter or over-budget candidate
                # never drains, so deferring it would waste windows): a
                # pending member of this class is inside its deadline-
                # close horizon — let it dispatch naturally and retire
                # at the next lull. Breaches keep accumulating, so the
                # deferral can't silently decay into never-retiring;
                # max_defer_windows hard-bounds it.
                track.defers += 1
                skip("deferred")
                continue
            if tracer is not None and tracer.enabled:
                tracer.instant("lifecycle.retire", "lifecycle",
                               args={"class": self._summary(sc),
                                     "reclassed": len(plan.names),
                                     "new_classes": plan.n_new_classes})
            window["retired"].append(self._summary(sc))
            window["reclassed"] += len(plan.names)
            window["recompiles"] += plan.n_new_classes
            window["drained_batches"] += self._retire(sc, plan)
            del self._tracks[sc]
            # successors start their own history; fresh ones get the
            # cooldown, pre-existing targets just reset their breach
            # streak (their waste profile changed under them).
            for nsc in plan.new_classes:
                self._tracks[nsc] = _ClassTrack(
                    cooldown=cfg.cooldown_windows)
            for tsc in set(plan.targets) - set(plan.new_classes):
                if tsc in self._tracks:
                    self._tracks[tsc].breaches = 0

        self.retires += len(window["retired"])
        self.reclassed_members += window["reclassed"]
        self.recompiles += window["recompiles"]
        self.drained_batches += window["drained_batches"]
        self.last_window = window
        return window

    def _retire(self, sc, plan: RetirementPlan) -> int:
        """Drain-then-invalidate: in-flight batches keyed on the
        retiring class dispatch first, then the engine mutation runs
        atomically with respect to new submissions (which therefore
        route to the successor class)."""
        result: dict = {}

        def execute():
            result.update(self.engine.execute_retirement(plan))

        frontend = self.frontend
        drained = 0
        drain = getattr(frontend, "drain_class", None)
        if drain is not None:
            drained = drain(sc, action=execute)
        else:
            execute()
        self.executors_invalidated += int(
            result.get("executors_invalidated", 0))
        return drained

    # ------------------------------------------------------------- stats ----
    @staticmethod
    def _summary(sc) -> str:
        summary = getattr(sc, "summary", None)
        return summary() if callable(summary) else str(sc)

    def snapshot(self) -> dict:
        """JSON-able cumulative counters + the last window's report;
        this is the ``Engine.stats()["lifecycle"]`` block."""
        out = {
            "windows": self.windows,
            "retires": self.retires,
            "reclassed_members": self.reclassed_members,
            "recompiles": self.recompiles,
            "executors_invalidated": self.executors_invalidated,
            "drained_batches": self.drained_batches,
            "skipped": dict(self.skipped),
            "tracked_classes": len(self._tracks),
            "breaching_classes": sum(1 for t in self._tracks.values()
                                     if t.breaches > 0),
            "last_window": dict(self.last_window),
        }
        registry = getattr(self.engine, "registry", None)
        if registry is not None and hasattr(registry, "stats"):
            out["registry"] = registry.stats()
        return out
