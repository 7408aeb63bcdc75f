"""Shape-class canonicalization of TriPartitions (serving layer).

Port of ``repro.engine.shape_class`` (host numpy, the same rules, so the
same registrations give the same classes and the same padded arrays as
the reference). Every distinct array shape is a distinct executor; a
serving engine amortizes that by padding each partition up to a small
set of canonical static shapes — a **shape class** — so structurally
similar graphs share one cached executor and one stacked group:

  * dense tile count          -> geometric (power-of-two) bucket
  * ELL ragged array          -> (Kmax, total units) + a descending-K
                                 band plan (``ell_bands``): Kmax snapped
                                 up the K ladder, unit count
                                 geometric-bucketed, band slot counts
                                 grown on the profile's cumulative
                                 counts, reuse bounded by a padded-MAC
                                 budget + per-slot width dominance
  * COO nnz                   -> geometric bucket
  * row/col tile counts       -> geometric bucket (bounds B padding)

All padding is value-neutral: zero tiles, zero ELL entries (``unit_k``
pads with 0), sentinel output rows, zero COO triples — the padded
partition computes exactly the same product as the original.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.formats import (CooResidual, DenseTiles,
                                      PartitionMeta, RaggedEll, TriPartition,
                                      to_numpy)
from repro_torch.kernels.ell_spmm import DEFAULT_MAX_BANDS, merge_bands

# Canonical slab widths for the ragged ELL array. Power-of-two rungs
# bound Kmax-padding waste at 2x on the widest unit; unlike the retired
# per-rung classing, only the partition's MAXIMUM K is snapped — the
# per-unit K stays exact in ``unit_k``.
DEFAULT_K_LADDER = (1, 2, 4, 8, 16, 32, 64, 128)


def _host(a, dtype) -> np.ndarray:
    """A host numpy copy-or-view of an array or (device) tensor."""
    return np.asarray(to_numpy(a), dtype)


def round_up_pow2(x: int, granule: int = 1) -> int:
    """Round x up to granule * 2^i (0 stays 0) — the geometric bucket."""
    if x <= 0:
        return 0
    g = max(int(granule), 1)
    n = -(-int(x) // g)
    p = 1
    while p < n:
        p <<= 1
    return p * g


def round_up_ladder(k: int, ladder) -> int:
    """Snap k up to the next ladder rung (multiples of the top rung above)."""
    if k <= 0:
        return 0
    for rung in ladder:
        if k <= rung:
            return rung
    top = ladder[-1]
    return -(-k // top) * top


@dataclasses.dataclass(frozen=True)
class ShapePolicy:
    """Knobs controlling how aggressively partitions are canonicalized.

    Coarser granules coalesce more graphs per class (fewer compiles) at
    the cost of more zero-padding work per inference.
    """

    k_ladder: tuple = DEFAULT_K_LADDER
    unit_granule: int = 4        # ragged ELL unit count
    dense_tile_granule: int = 4  # dense tile count
    coo_granule: int = 256       # COO nnz
    row_tile_granule: int = 4    # n_row_tiles / n_col_tiles
    # ClassRegistry knobs: a newly-founded class over-allocates every
    # count by ``growth`` (headroom for the next similar graph), and a
    # graph reuses an existing class only while the class's padded work
    # stays within ``fit_slack``x its real need (else padding waste would
    # exceed what the saved compile is worth). COO gets a tighter growth:
    # it usually dominates the per-inference nnz, and its count is far
    # more stable across a graph family than the Algorithm-2 ELL/dense
    # statistics (nnz totals jitter ~%, tile classifications jitter ~2x).
    growth: float = 2.0
    coo_growth: float = 1.25
    fit_slack: float = 4.0


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """A canonical static partition signature — the executor-cache key.

    Two graphs with equal ShapeClass (and equal feature widths) run
    through the *same* cached executor and may share one stacked group.
    The ELL slice is described by ``(ell_kmax, ell_units)`` plus an
    optional K-band plan ``ell_bands`` — descending (K, n_units) slot
    runs (``()`` means one Kmax-wide band). The band plan is kept
    exactly as in the reference, so classes and padded arrays match it;
    the ragged kernel takes per-unit K as data.
    """

    tile: int
    n_row_tiles: int
    n_col_tiles: int
    n_dense_tiles: int
    ell_kmax: int             # ragged slab width (ladder-snapped)
    ell_units: int            # ragged unit capacity
    coo_nnz: int
    r_block: int = 8          # unit row height — every member must match
    # Descending (K, n_units) band slots; sum of counts == ell_units.
    # () collapses to one (ell_kmax, ell_units) band via ``bands``.
    ell_bands: tuple = ()

    @property
    def bands(self) -> tuple:
        """The effective band plan (explicit, or one Kmax-wide band)."""
        if self.ell_bands:
            return self.ell_bands
        return ((self.ell_kmax, self.ell_units),) if self.ell_units else ()

    def to_meta(self) -> PartitionMeta:
        """The static PartitionMeta every member's executor runs with.

        nnz statistics are per-graph facts, not shape facts, so they are
        zeroed here — the executor never reads them, and keeping them
        would split classes that should share an executor. The segment
        map is the class's band plan: a padded member's units occupy
        exactly these descending-K slot runs (``unit_k`` carries the
        live widths; a unit's K never exceeds its slot's K).
        """
        return PartitionMeta(
            n_rows=self.n_row_tiles * self.tile,
            n_cols=self.n_col_tiles * self.tile,
            tile=self.tile,
            ell_ks=(self.ell_kmax,) if self.ell_units else (),
            n_row_tiles=self.n_row_tiles,
            n_col_tiles=self.n_col_tiles,
            n_dense_tiles=self.n_dense_tiles,
            nnz_dense=0, nnz_ell=0, nnz_ell_padded=0, nnz_coo=0,
            density_thresholds=(0.0, 0.0),
            ell_segments=self.bands,
        )

    @property
    def ell_mac_capacity(self) -> int:
        """Padded MAC slots the banded ragged kernel actually executes
        (per output feature): each slot runs its band's K trips, not the
        full Kmax."""
        return sum(k * n for k, n in self.bands) * self.r_block

    def summary(self) -> str:
        bands = (f" bands={list(self.ell_bands)}" if self.ell_bands else "")
        return (f"ShapeClass T={self.tile} tiles={self.n_row_tiles}x"
                f"{self.n_col_tiles} dense={self.n_dense_tiles} "
                f"ell=(Kmax={self.ell_kmax}, units={self.ell_units}){bands} "
                f"coo={self.coo_nnz}")


def _part_r_block(part: TriPartition, default: int = 8) -> int:
    """The partition's ELL unit row height (array-carried, U may be 0)."""
    r = int(part.ell.rows.shape[1]) if part.ell.rows.ndim == 2 else default
    return r or default


def shape_class_of(part: TriPartition, meta: PartitionMeta,
                   policy: ShapePolicy = ShapePolicy()) -> ShapeClass:
    """Stateless single-graph classification: the class this partition
    would found on its own, without registry headroom. One canonical
    path (``grow_class``) does all rounding so this can never drift from
    what `Engine` actually serves."""
    tight = dataclasses.replace(policy, growth=1.0, coo_growth=1.0)
    return grow_class(class_requirements(part, meta, tight), tight)


# ---------------------------------------------------------------------------
# Class registry — the serving-time classifier.
#
# Stateless per-graph bucketing (shape_class_of) splits classes whenever a
# count lands on the other side of a bucket boundary, and real graph
# families jitter by ~2x in their partition statistics. The registry makes
# sharing first-class: the first graph FOUNDS a class with `growth`
# headroom on every count, and later graphs reuse any registered class
# they fit inside, as long as the class's padded work stays within
# `fit_slack`x their real need.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClassNeed:
    """A partition's exact static-shape requirements (pre-snapping)."""

    tile: int
    n_row_tiles: int
    n_col_tiles: int
    square: bool
    n_dense_tiles: int
    ell_kmax: int             # widest unit's real K
    ell_units: int            # real unit count
    coo_nnz: int
    r_block: int = 8
    # Run-length (K, n_units) description of the partition's unit axis
    # in its actual (descending-K) order — the founder's band profile
    # and the per-slot fit evidence for joining a banded class.
    ell_band_profile: tuple = ()


def _round_mult(x: int, granule: int) -> int:
    g = max(int(granule), 1)
    return -(-int(x) // g) * g


def _run_lengths(unit_k: np.ndarray) -> tuple:
    """(K, count) runs of the unit axis in array order."""
    if unit_k.size == 0:
        return ()
    ks = unit_k.astype(np.int64)
    cuts = np.flatnonzero(np.diff(ks)) + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [ks.size]])
    return tuple((int(ks[s]), int(e - s)) for s, e in zip(starts, ends))


def _band_slots(bands) -> np.ndarray:
    """Expand (K, count) bands into a per-slot K vector."""
    if not bands:
        return np.zeros(0, np.int64)
    return np.repeat([k for k, _ in bands],
                     [n for _, n in bands]).astype(np.int64)


def _bands_admit(bands, profile) -> bool:
    """Per-slot dominance: unit i (width profile[i]) fits slot i.

    ``pad_to_class`` keeps unit order and appends padding at the end,
    so a partition is band-legal iff every unit's K is <= the K of the
    class slot at its position (trailing unused slots take the
    all-padding units, whose K is 0).
    """
    slots = _band_slots(bands)
    needs = _band_slots(profile)
    if needs.size > slots.size:
        return False
    return bool((needs <= slots[: needs.size]).all())


def class_requirements(part: TriPartition, meta: PartitionMeta,
                       policy: ShapePolicy = ShapePolicy()) -> ClassNeed:
    unit_k = to_numpy(part.ell.unit_k)
    return ClassNeed(
        tile=meta.tile,
        n_row_tiles=meta.n_row_tiles,
        n_col_tiles=meta.n_col_tiles,
        square=meta.n_rows == meta.n_cols,
        n_dense_tiles=int(part.dense.tiles.shape[0]),
        ell_kmax=int(unit_k.max()) if unit_k.size else 0,
        ell_units=int(unit_k.size),
        coo_nnz=int(part.coo.vals.shape[0]),
        r_block=_part_r_block(part),
        ell_band_profile=_run_lengths(unit_k),
    )


def class_fits(need: ClassNeed, sc: ShapeClass,
               policy: ShapePolicy = ShapePolicy()) -> bool:
    """Can `need` pad into `sc` without overflow or excessive waste?"""
    slack = policy.fit_slack

    def ok(cap, want, granule):
        return want <= cap <= slack * want + granule

    if sc.tile != need.tile:
        return False
    if need.ell_units and sc.r_block != need.r_block:
        return False
    if need.square and sc.n_row_tiles != sc.n_col_tiles:
        return False
    if not (ok(sc.n_row_tiles, need.n_row_tiles, policy.row_tile_granule)
            and ok(sc.n_col_tiles, need.n_col_tiles,
                   policy.row_tile_granule)):
        return False
    if not ok(sc.n_dense_tiles, need.n_dense_tiles,
              policy.dense_tile_granule):
        return False
    if not ok(sc.coo_nnz, need.coo_nnz, policy.coo_granule):
        return False

    # ELL: the ragged kernel needs only slab width (Kmax) and unit
    # capacity — no rung set. Two waste guards replace the retired
    # per-rung checks: the slab-width bound (joining a much wider class
    # turns every unit's masked tail into dead trips) and the
    # padded-MAC budget (all-padding capacity units are zero work the
    # kernel still executes at full Kmax width).
    if sc.ell_kmax < need.ell_kmax or sc.ell_units < need.ell_units:
        return False
    if need.ell_units:
        if sc.ell_kmax > slack * need.ell_kmax:
            return False
        class_macs = sum(k * n for k, n in sc.bands)
        budget = (slack * sc.ell_kmax * need.ell_units
                  + policy.unit_granule * sc.ell_kmax)
        if class_macs > budget:
            return False
        # banded classes additionally need per-slot width dominance:
        # unit i must fit the K of the class slot at position i
        profile = (need.ell_band_profile
                   or ((need.ell_kmax, need.ell_units),))
        return _bands_admit(sc.bands, profile)
    # a graph with no ELL work only joins classes with negligible slabs
    return sc.ell_units <= policy.unit_granule


def _grow_bands(need: ClassNeed, kmax: int, units: int,
                policy: ShapePolicy) -> tuple:
    """The founded class's K-band slot plan around ``need``'s profile.

    Band Ks are the profile's run Ks snapped up the ladder (top band
    widened to the class Kmax — the slab width); band counts grow on
    the profile's CUMULATIVE counts, so a later family member may shift
    units toward wider bands (density jitter) and still slot-fit.
    Non-descending profiles (legacy order) collapse to one band.
    Returns () when one band suffices — the implicit (kmax, units).
    """
    profile = [(int(k), int(n)) for k, n in
               (need.ell_band_profile or ((need.ell_kmax, need.ell_units),))
               if n > 0]
    ks = [k for k, _ in profile]
    if any(ks[i] < ks[i + 1] for i in range(len(ks) - 1)):
        return ()
    snapped = [(min(round_up_ladder(k, policy.k_ladder), kmax), n)
               for k, n in profile]
    runs = merge_bands(snapped, DEFAULT_MAX_BANDS)
    if len(runs) <= 1:
        return ()
    g = max(policy.growth, 1.0)
    bands: list = []
    cum_need = 0
    cum_class = 0
    for j, (k, n) in enumerate(runs):
        cum_need += n
        if j == len(runs) - 1:
            target = units                 # last band absorbs the rest
        else:
            target = min(units, max(
                _round_mult(int(cum_need * g), policy.unit_granule),
                cum_need))
        target = max(target, cum_class)
        bands.append((kmax if j == 0 else k, target - cum_class))
        cum_class = target
    bands = merge_bands(bands, DEFAULT_MAX_BANDS)
    return bands if len(bands) > 1 else ()


def grow_class(need: ClassNeed,
               policy: ShapePolicy = ShapePolicy()) -> ShapeClass:
    """Found a new class around `need`, with growth headroom per count."""
    g = policy.growth
    nrt = round_up_pow2(need.n_row_tiles, policy.row_tile_granule)
    nct = round_up_pow2(need.n_col_tiles, policy.row_tile_granule)
    if need.square:
        nrt = nct = max(nrt, nct)
    # Kmax gets growth headroom too (capped at the tile edge — a
    # tile-local row can never exceed T nnz) so family members whose
    # widest unit jitters past the founder's still share the class.
    ell_kmax = (round_up_ladder(min(int(need.ell_kmax * g), need.tile),
                                policy.k_ladder)
                if need.ell_units else 0)
    ell_units = (_round_mult(int(need.ell_units * g), policy.unit_granule)
                 if need.ell_units else 0)
    return ShapeClass(
        tile=need.tile,
        n_row_tiles=nrt,
        n_col_tiles=nct,
        n_dense_tiles=_round_mult(int(need.n_dense_tiles * g),
                                  policy.dense_tile_granule),
        ell_kmax=ell_kmax,
        ell_units=ell_units,
        coo_nnz=_round_mult(int(need.coo_nnz * policy.coo_growth),
                            policy.coo_granule),
        r_block=need.r_block,
        ell_bands=_grow_bands(need, ell_kmax, ell_units, policy)
        if need.ell_units else (),
    )


class ClassRegistry:
    """First-fit registry of founded shape classes (one per Engine).

    The registry is the single source of truth for grouping: every graph
    the engine serves was classified here, and the lifecycle manager's
    retirement decisions mutate *this* list — never per-graph state —
    so classification and serving can't drift apart.

    Lifecycle paths:

      * ``retire(sc)`` removes a class from the live list so no future
        graph joins it; the class is remembered in ``retired`` so a
        later identical founding is visible as a **refound** (a signal
        the retirement was premature — the traffic came back).
      * ``admit(sc)`` re-admits a concrete class (a retirement plan's
        successor) into the live list, un-retiring it if needed.
      * ``plan_reclass(needs, ...)`` is the pure planning half of
        recompile-on-drift: first-fit the needs into surviving classes,
        founding tight new ones only where nothing fits — without
        mutating the registry, so the lifecycle manager can budget the
        recompiles a retirement would cost *before* committing to it.
    """

    def __init__(self, policy: ShapePolicy = ShapePolicy()):
        self.policy = policy
        self.classes: list = []
        self.retired: list = []
        self.retire_count = 0
        self.refounds = 0

    def classify(self, part: TriPartition,
                 meta: PartitionMeta) -> ShapeClass:
        return self.classify_need(class_requirements(part, meta, self.policy))

    def classify_need(self, need: ClassNeed) -> ShapeClass:
        for sc in self.classes:
            if class_fits(need, sc, self.policy):
                return sc
        sc = grow_class(need, self.policy)
        self._found(sc)
        return sc

    def _found(self, sc: ShapeClass) -> None:
        """Add a class to the live list, counting retired-class revivals."""
        if sc in self.retired:
            self.retired.remove(sc)
            self.refounds += 1
        if sc not in self.classes:
            self.classes.append(sc)

    # ----------------------------------------------------- lifecycle ----
    def retire(self, sc: ShapeClass) -> bool:
        """Remove ``sc`` from the live list; no future graph joins it."""
        if sc not in self.classes:
            return False
        self.classes.remove(sc)
        if sc not in self.retired:
            self.retired.append(sc)
        self.retire_count += 1
        return True

    def admit(self, sc: ShapeClass) -> None:
        """Re-admission path: make a planned successor class live."""
        self._found(sc)

    def plan_reclass(self, needs, exclude=(),
                     found_policy: Optional[ShapePolicy] = None) -> tuple:
        """Dry-run first-fit of ``needs`` with ``exclude`` classes gone.

        Returns ``(targets, new_classes)``: ``targets[i]`` is the class
        ``needs[i]`` would land in, drawn from surviving live classes
        first, then from classes this plan already founded, then by
        founding a fresh class with ``found_policy`` (default: the
        registry policy with growth 1.0 — retirement re-founds *tight*,
        the members are known and headroom is what caused the waste).
        Pure: the registry is not mutated; ``Engine.execute_retirement``
        applies the plan.
        """
        if found_policy is None:
            found_policy = dataclasses.replace(self.policy, growth=1.0,
                                               coo_growth=1.0)
        live = [c for c in self.classes if c not in exclude]
        new: list = []
        targets: list = []
        for need in needs:
            target = next((c for c in live
                           if class_fits(need, c, self.policy)), None)
            if target is None:
                target = next((c for c in new
                               if class_fits(need, c, self.policy)), None)
            if target is None:
                target = grow_class(need, found_policy)
                new.append(target)
            targets.append(target)
        return targets, new

    def stats(self) -> dict:
        return {"live_classes": len(self.classes),
                "retired_classes": len(self.retired),
                "retires": self.retire_count,
                "refounds": self.refounds}


def pad_to_class(part: TriPartition, meta: PartitionMeta,
                 sc: ShapeClass) -> tuple:
    """Pad a partition's arrays to exactly the class shapes.

    Returns ``(padded TriPartition, padded PartitionMeta)`` — host-side
    numpy throughout; ``Engine.register`` places them on the device.
    Padding is value-neutral by construction:

      * dense: zero tiles scattered onto block-row 0 (adds 0)
      * ELL:   the ragged slab widens to the class Kmax (zero cols/vals
               columns, ``unit_k`` untouched) and gains all-padding
               units (``unit_k == 0``) carrying the padded meta's
               sentinel output row
      * COO:   (row 0, col 0, val 0) triples (adds 0)
    """
    if sc.tile != meta.tile:
        raise ValueError(f"tile mismatch: class {sc.tile} vs meta {meta.tile}")
    pmeta = dataclasses.replace(
        sc.to_meta(),
        nnz_dense=meta.nnz_dense, nnz_ell=meta.nnz_ell,
        nnz_ell_padded=meta.nnz_ell_padded, nnz_coo=meta.nnz_coo,
        density_thresholds=meta.density_thresholds,
    )
    T = meta.tile

    # ---- dense ------------------------------------------------------------
    n_t = int(part.dense.tiles.shape[0])
    if n_t > sc.n_dense_tiles:
        raise ValueError(f"class holds {sc.n_dense_tiles} dense tiles, "
                         f"partition has {n_t}")
    pad_t = sc.n_dense_tiles - n_t
    dense = DenseTiles(
        tiles=np.concatenate(
            [_host(part.dense.tiles, np.float32),
             np.zeros((pad_t, T, T), np.float32)], axis=0),
        tile_row=np.concatenate([_host(part.dense.tile_row, np.int32),
                                 np.zeros(pad_t, np.int32)]),
        tile_col=np.concatenate([_host(part.dense.tile_col, np.int32),
                                 np.zeros(pad_t, np.int32)]),
    )

    # ---- ELL: widen the slab to class Kmax, append all-padding units ------
    sentinel_old = meta.ell_sentinel_row
    sentinel_new = pmeta.ell_sentinel_row
    u, rb, kmax = (int(s) for s in part.ell.cols.shape)
    if u > sc.ell_units:
        raise ValueError(f"class holds {sc.ell_units} ELL units, "
                         f"partition has {u}")
    if u and kmax > sc.ell_kmax:
        raise ValueError(f"class slab Kmax={sc.ell_kmax} narrower than "
                         f"partition Kmax={kmax}")
    if u and rb != sc.r_block:
        raise ValueError(f"unit row height {rb} != class r_block "
                         f"{sc.r_block}")
    if u and sc.ell_bands:
        # banded class: unit i must fit the K of slot i (the reference's
        # band chains must cover unit_k[i]; kept for class parity)
        slots = _band_slots(sc.bands)
        uk = _host(part.ell.unit_k, np.int64)
        if not (uk <= slots[:u]).all():
            bad = int(np.flatnonzero(uk > slots[:u])[0])
            raise ValueError(
                f"unit {bad} (K={int(uk[bad])}) exceeds class band slot "
                f"K={int(slots[bad])}")
    rb = sc.r_block
    pad_u = sc.ell_units - u
    cols = np.zeros((sc.ell_units, rb, sc.ell_kmax), np.int32)
    vals = np.zeros((sc.ell_units, rb, sc.ell_kmax), np.float32)
    if u:
        cols[:u, :, :kmax] = _host(part.ell.cols, np.int32)
        vals[:u, :, :kmax] = _host(part.ell.vals, np.float32)
        rows = _host(part.ell.rows, np.int32).copy()
        # remap the source partition's sentinel into the padded space
        rows[rows == sentinel_old] = sentinel_new
    else:
        rows = np.zeros((0, rb), np.int32)
    ell = RaggedEll(
        cols=cols,
        vals=vals,
        rows=np.concatenate(
            [rows, np.full((pad_u, rb), sentinel_new, np.int32)], axis=0),
        tile_col=np.concatenate([_host(part.ell.tile_col, np.int32),
                                 np.zeros(pad_u, np.int32)]),
        unit_k=np.concatenate([_host(part.ell.unit_k, np.int32),
                               np.zeros(pad_u, np.int32)]),
    )

    # ---- COO --------------------------------------------------------------
    nnz = int(part.coo.vals.shape[0])
    if nnz > sc.coo_nnz:
        raise ValueError(f"class holds {sc.coo_nnz} COO nnz, partition "
                         f"has {nnz}")
    pad_c = sc.coo_nnz - nnz
    coo = CooResidual(
        rows=np.concatenate([_host(part.coo.rows, np.int32),
                             np.zeros(pad_c, np.int32)]),
        cols=np.concatenate([_host(part.coo.cols, np.int32),
                             np.zeros(pad_c, np.int32)]),
        vals=np.concatenate([_host(part.coo.vals, np.float32),
                             np.zeros(pad_c, np.float32)]),
    )

    return TriPartition(dense=dense, ell=ell, coo=coo), pmeta


def unpad_from_class(part: TriPartition, padded_meta: PartitionMeta,
                     meta: PartitionMeta) -> TriPartition:
    """Invert `pad_to_class`: recover the original partition arrays.

    ``pad_to_class`` only ever *appends* value-neutral padding (dense
    tiles, ELL Kmax columns + all-padding units, COO triples), so the
    original arrays are exact prefixes; the one non-slice operation is
    mapping the padded meta's ELL sentinel row back to the original's.
    This is what lets retirement re-pad a member into a tighter
    successor class without keeping a second, unpadded copy of every
    registered graph alive: ``pad_to_class(unpad_from_class(p), m, sc')``
    round-trips bit-for-bit.

    Host-side numpy throughout (``part`` may be device-resident).
    """
    u = sum(n for _, n in meta.ell_segments)
    kmax = max((k for k, _ in meta.ell_segments), default=0)
    rows = to_numpy(part.ell.rows)[:u].copy()
    rows[rows == padded_meta.ell_sentinel_row] = meta.ell_sentinel_row
    return TriPartition(
        dense=DenseTiles(
            tiles=to_numpy(part.dense.tiles)[: meta.n_dense_tiles],
            tile_row=to_numpy(part.dense.tile_row)[: meta.n_dense_tiles],
            tile_col=to_numpy(part.dense.tile_col)[: meta.n_dense_tiles],
        ),
        ell=RaggedEll(
            cols=to_numpy(part.ell.cols)[:u, :, :kmax],
            vals=to_numpy(part.ell.vals)[:u, :, :kmax],
            rows=rows,
            tile_col=to_numpy(part.ell.tile_col)[:u],
            unit_k=to_numpy(part.ell.unit_k)[:u],
        ),
        coo=CooResidual(
            rows=to_numpy(part.coo.rows)[: meta.nnz_coo],
            cols=to_numpy(part.coo.cols)[: meta.nnz_coo],
            vals=to_numpy(part.coo.vals)[: meta.nnz_coo],
        ),
    )
