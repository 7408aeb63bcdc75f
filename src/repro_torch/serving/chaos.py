"""Deterministic chaos injection for the serving stack.

Port of ``repro.serving.chaos``; pure Python.

The serving stack (frontend -> scheduler -> pipeline -> replicas ->
engine) contains several places where a real deployment fails: a
dispatch raises, a compile step errors, a device future never becomes
ready, a single request poisons a whole batch with NaNs, a replica
dies.  This module provides a *deterministic, seeded* way to trigger
each of those failures at named injection sites so the resilience
layer (``repro_torch.serving.resilience``) can be exercised under test
and in the tier-1 chaos smoke — without wall-clock dependence and fully
compatible with ``SimClock`` runs.

Design mirrors the tracer (``repro_torch.obs.trace``):

- ``NULL_INJECTOR`` is a disabled singleton.  Every hot-path call
  checks ``injector.enabled`` first, so the production path costs one
  attribute read — the same zero-cost-off contract as ``NULL_TRACER``.
- Components accept an injector via ``attach_injector`` (duck-typed,
  like ``attach_tracer``) so stubs and real engines wire identically.

Sites (the complete failure taxonomy — see docs/ROBUSTNESS.md):

``"dispatch"``
    Raise :class:`InjectedFault` when a batch is handed to the engine.
    ``mode="transient"`` faults succeed on retry; ``mode="permanent"``
    faults re-fire on every retry of the same occurrence.
``"compile"``
    Raise :class:`InjectedFault` inside the executor-cache miss path,
    before the build runs (always transient: a rebuild succeeds).
``"hang"``
    The dispatched batch's device future never becomes ready; only the
    dispatch watchdog can convert this into a retryable fault.
``"poison"``
    Persistently mark one member *request name* as poisoned; the engine
    (stub or real) emits non-finite outputs for that name on every
    dispatch,
    so quarantine bisection can isolate it.
``"replica"``
    Kill the serving replica (reuses the ``ReplicaSet``'s
    ``ReplicaFault`` rescue path).

Occurrence counting: each site keeps an independent counter of polls;
a :class:`FaultSpec` fires when its site's counter reaches ``at``
(0-based).  This makes a plan reproducible run-to-run regardless of
thread interleaving in *which* batch hits an occurrence index, while
tests on ``SimClock`` get exact, bitwise-stable schedules.

>>> plan = FaultPlan([FaultSpec(site="dispatch", at=1)])
>>> inj = ChaosInjector(plan)
>>> inj.poll("dispatch") is None   # occurrence 0: clean
True
>>> inj.poll("dispatch").site      # occurrence 1: fires
'dispatch'
>>> inj.poll("dispatch") is None   # occurrence 2: clean again
True
>>> NULL_INJECTOR.enabled
False
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

SITES = ("dispatch", "compile", "hang", "poison", "replica")

MODES = ("transient", "permanent")


class InjectedFault(RuntimeError):
    """A failure raised by the chaos harness at an injection site.

    ``transient`` tells the resilience layer whether a retry of the
    same work is expected to succeed (the injector will not re-fire
    the same occurrence) or fail again (``mode="permanent"``).
    """

    def __init__(self, site: str, *, transient: bool = True, detail: str = ""):
        msg = f"injected fault at site={site!r} ({'transient' if transient else 'permanent'})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.site = site
        self.transient = transient
        self.detail = detail


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault.

    site
        One of :data:`SITES`.
    at
        0-based occurrence index on that site's poll counter.
    mode
        ``"transient"`` (default) or ``"permanent"`` — only meaningful
        for ``"dispatch"``; retries of a permanent fault re-raise.
    member
        For ``"poison"``: index into the faulted batch's member list
        choosing which request name gets marked poisoned.
    replica
        Restrict the fault to one replica id (``None`` = any).
    """

    site: str
    at: int
    mode: str = "transient"
    member: int = 0
    replica: Optional[int] = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown injection site {self.site!r}; expected one of {SITES}")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; expected one of {MODES}")
        if self.at < 0:
            raise ValueError("occurrence index must be >= 0")


@dataclass
class FaultPlan:
    """An immutable-ish schedule of :class:`FaultSpec` entries.

    Build one explicitly for targeted tests, or use :meth:`seeded` for
    a reproducible pseudo-random mix across all site types.

    >>> p = FaultPlan.seeded(seed=7, n_faults=6, horizon=50)
    >>> len(p.specs)
    6
    >>> p2 = FaultPlan.seeded(seed=7, n_faults=6, horizon=50)
    >>> p.specs == p2.specs      # same seed -> identical plan
    True
    """

    specs: Sequence[FaultSpec] = field(default_factory=tuple)

    def __post_init__(self):
        self.specs = tuple(self.specs)

    @classmethod
    def seeded(
        cls,
        seed: int,
        *,
        n_faults: int = 8,
        horizon: int = 64,
        sites: Sequence[str] = SITES,
        n_replicas: int = 1,
        permanent_frac: float = 0.25,
    ) -> "FaultPlan":
        """Draw ``n_faults`` specs from ``sites`` with occurrence
        indices in ``[0, horizon)`` using a seeded generator.  No
        wall-clock, no global RNG state."""
        rng = np.random.default_rng(seed)
        specs = []
        used = set()
        for _ in range(n_faults):
            site = sites[int(rng.integers(len(sites)))]
            at = int(rng.integers(horizon))
            while (site, at) in used:
                at = int(rng.integers(horizon))
            used.add((site, at))
            mode = "permanent" if (site == "dispatch" and rng.random() < permanent_frac) else "transient"
            member = int(rng.integers(8))
            replica = int(rng.integers(n_replicas)) if n_replicas > 1 and rng.random() < 0.5 else None
            specs.append(FaultSpec(site=site, at=at, mode=mode, member=member, replica=replica))
        return cls(tuple(specs))

    def for_site(self, site: str) -> tuple:
        return tuple(s for s in self.specs if s.site == site)


class ChaosInjector:
    """Polls a :class:`FaultPlan` at named injection sites.

    Thread-safe: occurrence counters and the poisoned-name set are
    guarded by ``_lock``.  The disabled path (``NULL_INJECTOR``) is a
    single attribute check — callers must test ``enabled`` before
    calling :meth:`poll` on hot paths.
    """

    def __init__(self, plan: Optional[FaultPlan] = None, *, enabled: bool = True):
        self.enabled = enabled and plan is not None and len(plan.specs) > 0
        self.plan = plan if plan is not None else FaultPlan(())
        self._lock = threading.Lock()
        self._counts = {site: 0 for site in SITES}
        self._fired = []  # [(site, at)] in fire order, for reporting
        self._poisoned = set()
        # index once: site -> {occurrence: spec}
        self._by_site = {}
        for s in self.plan.specs:
            self._by_site.setdefault(s.site, {})[s.at] = s

    def poll(self, site: str, replica: Optional[int] = None) -> Optional[FaultSpec]:
        """Advance ``site``'s occurrence counter; return the spec that
        fires at this occurrence (replica-filtered), else ``None``."""
        if not self.enabled:
            return None
        with self._lock:
            idx = self._counts[site]
            self._counts[site] = idx + 1
            spec = self._by_site.get(site, {}).get(idx)
            if spec is None:
                return None
            if spec.replica is not None and replica is not None and spec.replica != replica:
                return None
            self._fired.append((site, idx))
            return spec

    # -- poison bookkeeping -------------------------------------------------
    # Poison is a property of the *request name*, not of one dispatch:
    # once marked, every dispatch containing the name yields non-finite
    # output, which is what makes bisection able to isolate it.

    def mark_poisoned(self, name: str) -> None:
        with self._lock:
            self._poisoned.add(name)

    def is_poisoned(self, name: str) -> bool:
        if not self.enabled:
            return False
        with self._lock:
            return name in self._poisoned

    def poisoned_names(self) -> frozenset:
        with self._lock:
            return frozenset(self._poisoned)

    # -- reporting ----------------------------------------------------------

    def fired(self) -> tuple:
        """(site, occurrence) pairs that have fired so far, in order."""
        with self._lock:
            return tuple(self._fired)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "planned": len(self.plan.specs),
                "fired": len(self._fired),
                "poisoned": sorted(self._poisoned),
                "polls": dict(self._counts),
            }


NULL_INJECTOR = ChaosInjector(None, enabled=False)
