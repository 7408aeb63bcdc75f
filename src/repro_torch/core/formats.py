"""Sparse-matrix containers for the tri-engine H-GCN executor (PyTorch port).

Port of ``repro.core.formats``. The containers keep the reference's
names, fields and dtypes. Host preprocessing (partitioning, class
padding) fills them with numpy arrays, exactly as the reference does;
``partition_to`` places them on a device as tensors (float32 values,
int32 indices). Every device-side function also accepts a leading group
axis ``G`` on all leaves, which is how ``Engine.serve_group`` runs a
whole group in one launch per kernel.

The three components mirror the paper's three engines:

  * ``DenseTiles``  — tightly-clustered T×T tiles (dense engine).
  * ``RaggedEll``   — loosely-clustered tiles in tile-local ELLPACK form,
                      one concatenated unit array padded to Kmax with the
                      real per-unit width in ``unit_k`` (sparse engine).
  * ``CooResidual`` — scattered nnz in COO (flexible engine).

The per-K view (``EllTileBucket``) is derived from the ragged array by
``ell_buckets`` for the "fused"/"loop" dispatches, one fixed-K kernel
launch per bucket (class band); the device format of record stays the
ragged array.

Deterministic reductions. Several dense tiles, ELL units and COO entries
add into the same output row. On CUDA, ``index_add_``/``scatter_add_``
use atomics whose order changes from run to run, so the port never uses
them for float sums. Instead every reduction onto output rows goes
through a ``SegmentPlan`` built once on the host with numpy: the entries
to sum, stably sorted by destination, and the count per destination.
``segment_sum`` then adds each destination's entries one after another
in that fixed order, so results are bitwise-repeatable. The per-K
dispatches' ELL rows are summed inside their kernel, band by band, in
the same order (``BandPlan``, ``band_plans``).

Invariant: dense + ell + coo exactly reconstructs A (padding values are 0).
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class CSRMatrix(NamedTuple):
    """Host-side CSR (numpy) — the preprocessing input format (paper §IV-C)."""

    indptr: np.ndarray   # [n_rows + 1] int64
    indices: np.ndarray  # [nnz] int32
    data: np.ndarray     # [nnz] float32
    shape: tuple         # (n_rows, n_cols)


class DenseTiles(NamedTuple):
    """Tightly-clustered tiles: block-sparse (BSR-like) dense tile stack."""

    tiles: torch.Tensor     # [n_tiles, T, T] float32 — dense tile values
    tile_row: torch.Tensor  # [n_tiles] int32 — block-row of each tile
    tile_col: torch.Tensor  # [n_tiles] int32 — block-col of each tile


class EllTileBucket(NamedTuple):
    """Per-K view of ELL *units*: a slice of the ragged array whose units
    share one band width K (``cols``/``vals`` are views ``[..., :K]`` of
    the ragged slab, not copies). Padded entries have ``vals == 0`` and
    ``cols == 0``; padded rows carry the sentinel row id. A leading group
    axis is kept when the ragged array has one.
    """

    cols: torch.Tensor      # [(G,) n_units, R_BLOCK, K] int32
    vals: torch.Tensor      # [(G,) n_units, R_BLOCK, K] float32
    rows: torch.Tensor      # [(G,) n_units, R_BLOCK] int32
    tile_col: torch.Tensor  # [(G,) n_units] int32


class RaggedEll(NamedTuple):
    """ALL ELL units in one concatenated array, padded to the global Kmax.

    Units are ordered by DESCENDING K; entries at or past a unit's K are
    zero (``vals == 0``, ``cols == 0``). Padded *rows* carry the sentinel
    row id ``n_row_tiles * T`` (``PartitionMeta.ell_sentinel_row``).
    Column indices are tile-local (< T).
    """

    cols: torch.Tensor      # [U, R_BLOCK, Kmax] int32 — tile-local cols
    vals: torch.Tensor      # [U, R_BLOCK, Kmax] float32
    rows: torch.Tensor      # [U, R_BLOCK] int32 — global output rows
    tile_col: torch.Tensor  # [U] int32 — which T-wide column tile of B
    unit_k: torch.Tensor    # [U] int32 — real K of each unit (<= Kmax)

    @property
    def n_units(self) -> int:
        return self.cols.shape[-3]

    @property
    def r_block(self) -> int:
        return self.cols.shape[-2]

    @property
    def kmax(self) -> int:
        return self.cols.shape[-1]


def empty_ragged_ell(r_block: int = 8, kmax: int = 0,
                     device="cuda") -> RaggedEll:
    """A RaggedEll with zero units (graphs with no sparse-engine work),
    on ``device``, in the reference's dtypes."""
    dev = resolve_device(device)
    return RaggedEll(
        cols=torch.zeros((0, r_block, kmax), dtype=torch.int32, device=dev),
        vals=torch.zeros((0, r_block, kmax), dtype=torch.float32,
                         device=dev),
        rows=torch.zeros((0, r_block), dtype=torch.int32, device=dev),
        tile_col=torch.zeros((0,), dtype=torch.int32, device=dev),
        unit_k=torch.zeros((0,), dtype=torch.int32, device=dev),
    )


def _bucket_slices(u: int, kmax: int, segments) -> list:
    """[(K, unit slice), ...] of the buckets of a ``u``-unit array."""
    if u == 0:
        return []
    segs = tuple(segments) if segments else ((kmax, u),)
    if sum(n for _, n in segs) != u:
        raise ValueError(f"ell_segments {segs} do not cover {u} units")
    out, start = [], 0
    for k, n in segs:
        out.append((int(k), slice(start, start + n)))
        start += n
    return out


def ell_buckets(ell: RaggedEll, segments: tuple = ()) -> tuple:
    """The fixed-K bucket tuple of the ragged array (reference
    ``repro.core.formats.ell_buckets``).

    ``segments`` is the ((K, n_units), ...) run-length description of
    the unit axis (``PartitionMeta.ell_segments``); without it the whole
    array is one Kmax-wide bucket (correct because entries past
    ``unit_k`` are zero). Raises ``ValueError`` when the segments do not
    cover the units. Works on numpy arrays and tensors, with or without
    a leading group axis; slices are views.
    """
    return tuple(
        EllTileBucket(cols=ell.cols[..., sl, :, :k],
                      vals=ell.vals[..., sl, :, :k],
                      rows=ell.rows[..., sl, :],
                      tile_col=ell.tile_col[..., sl])
        for k, sl in _bucket_slices(int(ell.cols.shape[-3]),
                                    int(ell.cols.shape[-1]), segments))


class CooResidual(NamedTuple):
    """Scattered nnz — fully general COO, executed on the flexible path."""

    rows: torch.Tensor  # [nnz] int32 (global row index)
    cols: torch.Tensor  # [nnz] int32 (global col index)
    vals: torch.Tensor  # [nnz] float32


class TriPartition(NamedTuple):
    """The full heterogeneous decomposition of a sparse matrix A."""

    dense: DenseTiles
    ell: RaggedEll
    coo: CooResidual


@dataclasses.dataclass(frozen=True)
class PartitionMeta:
    """Static facts about a TriPartition (same fields as the reference).

    ``config``, not a field (the reference's meta has none, and equal
    partitions compare equal whatever made them): the
    ``PartitionConfig`` that ``analyze_and_partition`` ran with, which
    ``partition.config_of`` hands to Aᵀ's partition; None on a meta
    built otherwise.
    """

    n_rows: int
    n_cols: int
    tile: int                  # T — tile edge
    ell_ks: tuple              # distinct ELL K widths, ascending
    n_row_tiles: int
    n_col_tiles: int
    n_dense_tiles: int
    nnz_dense: int
    nnz_ell: int               # real (non-padding) nnz on the ELL path
    nnz_ell_padded: int        # nnz incl. padding actually computed
    nnz_coo: int
    density_thresholds: tuple  # (d_dense, d_scatter)
    # ((K, n_units), ...) runs of the ragged unit axis, DESCENDING K.
    ell_segments: tuple = ()
    config = None

    @property
    def nnz(self) -> int:
        return self.nnz_dense + self.nnz_ell + self.nnz_coo

    @property
    def n_padded_rows(self) -> int:
        """Output rows of the padded row-tile space (n_row_tiles * T)."""
        return self.n_row_tiles * self.tile

    @property
    def ell_sentinel_row(self) -> int:
        """Output-row id carried by padded ELL unit rows.

        Equal to ``n_padded_rows`` — one past the last real padded row.
        The ELL reduction never reads entries bound for it, so padding
        rows never touch real output.
        """
        return self.n_padded_rows

    def summary(self) -> str:
        tot = max(self.nnz, 1)
        return (
            f"TriPartition {self.n_rows}x{self.n_cols} T={self.tile} "
            f"nnz={self.nnz} | dense {self.nnz_dense} ({self.nnz_dense/tot:.1%}) "
            f"| ell {self.nnz_ell} ({self.nnz_ell/tot:.1%}, pad-overhead "
            f"{(self.nnz_ell_padded - self.nnz_ell)/max(self.nnz_ell,1):.2f}x) "
            f"| coo {self.nnz_coo} ({self.nnz_coo/tot:.1%}) "
            f"| ragged K={list(self.ell_ks)}"
        )


# ------------------------------------------------------------ placement ----
_LEAF_DTYPES = TriPartition(
    dense=DenseTiles(np.float32, np.int32, np.int32),
    ell=RaggedEll(np.int32, np.float32, np.int32, np.int32, np.int32),
    coo=CooResidual(np.int32, np.int32, np.float32),
)
_TORCH_DTYPES = {np.float32: torch.float32, np.int32: torch.int32,
                 np.int64: torch.int64}


def to_numpy(a) -> np.ndarray:
    """A host numpy view of an array or tensor (device tensors copy back)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# host plans built from a stand-in index (``plan_index``) in this process
STAND_IN = {"plans": 0}


def plan_index(idx, bound: int) -> np.ndarray:
    """The host values of an index array that a plan is built from. A
    ``FakeTensor`` (the dry-run's trace, ``launch/dryrun.py``) has no
    values: its stand-in is ``arange(numel) % bound`` in its shape, an
    index of the same shape and bound, so the plan's shapes, and the
    FLOPs and collectives of the ops that read it, are those of any real
    index (``SegmentPlan.live`` keeps only live segments, so its size is
    the stand-in's). Counted in ``STAND_IN``. Any other array: its
    values (``to_numpy``)."""
    from torch._subclasses.fake_tensor import FakeTensor

    if not isinstance(idx, FakeTensor):
        return to_numpy(idx)
    STAND_IN["plans"] += 1
    n = int(np.prod(tuple(idx.shape)))
    return (np.arange(n, dtype=np.int64) % max(int(bound), 1)).reshape(
        tuple(idx.shape))


def _to_tensor(a, np_dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=_TORCH_DTYPES[np_dtype])
    return torch.from_numpy(np.array(a, dtype=np_dtype)).to(device)


def partition_to(part: TriPartition, device) -> TriPartition:
    """Every leaf of ``part`` as a tensor on ``device`` (reference dtypes).

    Leaves already on ``device`` with the right dtype are returned as is.
    """
    return TriPartition(*(
        type(comp)(*(_to_tensor(a, dt, device) for a, dt in zip(comp, dts)))
        for comp, dts in zip(part, _LEAF_DTYPES)))


def pad_b_to_tiles(b: torch.Tensor, meta: PartitionMeta) -> torch.Tensor:
    """Pad B's rows (axis -2) up to n_col_tiles * T so tile gathers are
    in-bounds. A leading group axis is kept."""
    want = meta.n_col_tiles * meta.tile
    if b.shape[-2] == want:
        return b
    return torch.nn.functional.pad(b, (0, 0, 0, want - b.shape[-2]))


def b_tiles_of(b: torch.Tensor, meta: PartitionMeta) -> torch.Tensor:
    """B [G, N, F] viewed as column tiles [G, nct, T, F]."""
    bp = pad_b_to_tiles(b, meta)
    return bp.reshape(bp.shape[0], meta.n_col_tiles, meta.tile, bp.shape[-1])


# ------------------------------------------------ deterministic reduction ----
class SegmentPlan(NamedTuple):
    """A fixed-order reduction of ``n_entries`` rows onto segments.

    ``order`` lists the entries that take part, stably sorted by their
    destination segment; ``lengths`` holds the number of entries per
    segment (zero-length segments sum to 0). For a group of G members,
    entries and segments are numbered member by member (member g's
    entry i is ``g * n_entries + i``). ``offsets`` is where each segment
    starts in ``order`` (the cumulative sum of ``lengths`` after a 0,
    ``segment_offsets``), which the kernels that fold a sum in read.
    ``live`` [G, L] lists, per member, the segments with at least one
    entry (ids over the whole group, ascending), padded with -1 to the
    member with the most (``segment_live``): the grid of the ELL row
    kernel.
    """

    order: torch.Tensor    # [n_sel] int64
    lengths: torch.Tensor  # [G * n_segments] int64
    n_entries: int         # entries per member
    offsets: torch.Tensor  # [G * n_segments + 1] int64
    live: torch.Tensor     # [G, L] int64, -1 past a member's last


def segment_offsets(lengths: np.ndarray) -> np.ndarray:
    """[0, cumsum(lengths)...]: segment s of a plan is
    ``order[offsets[s]:offsets[s + 1]]``."""
    lengths = np.asarray(lengths, np.int64)
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


def segment_live(member_lengths) -> np.ndarray:
    """[G, L] int64: member g's segments with entries, as ids over the
    group (``g * n_segments + s``), padded with -1 to the longest
    member's count L. ``member_lengths`` holds each member's lengths."""
    ids, at = [], 0
    for lengths in member_lengths:
        lengths = np.asarray(lengths).reshape(-1)
        ids.append(np.flatnonzero(lengths) + at)
        at += lengths.shape[0]
    out = np.full((len(ids), max((i.size for i in ids), default=0)), -1,
                  np.int64)
    for g, i in enumerate(ids):
        out[g, :i.size] = i
    return out


class RowOrder(NamedTuple):
    """The live segments of a plan in launch order: the segments with the
    most entries first, ties in ascending id (``row_order``). The COO row
    kernel walks its rows in this order, so the longest chains start
    first; the order changes no sum.

    ``at_least[k]`` counts the segments with at least ``2**k`` entries
    (up to the longest segment's power of two), so the first
    ``at_least[k]`` of ``rows`` are exactly those: the kernel's wrapper
    reads how many rows are long without reading the device.
    """

    rows: torch.Tensor   # [n_live] int64 segment ids over the group
    at_least: tuple      # segments with >= 2**k entries, k = 0, 1, ...

    def n_at_least(self, n: int) -> int:
        """The segments with at least ``n`` entries (``n`` a power of two
        from 1)."""
        k = int(n).bit_length() - 1
        if n < 1 or 1 << k != n:
            raise ValueError(f"n_at_least: {n} is not a power of two")
        return self.at_least[k] if k < len(self.at_least) else 0


def row_order(lengths) -> RowOrder:
    """The ``RowOrder`` of a plan's ``lengths`` (host numpy)."""
    lengths = np.asarray(lengths, np.int64).reshape(-1)
    live = np.flatnonzero(lengths)
    rows = live[np.argsort(-lengths[live], kind="stable")]
    top = int(lengths.max(initial=0))
    return RowOrder(rows.astype(np.int64), tuple(
        int((lengths >= 1 << k).sum()) for k in range(top.bit_length())))


class ReductionPlan(NamedTuple):
    """The per-partition reductions onto output rows.

    ``ell_bucket_k`` [U] int32 is the K of each ELL unit's bucket of
    ``meta.ell_segments`` (``bucket_bounds``; every member of a group
    shares it): the per-K dispatches' kernel reads each unit to it.
    ``coo_rows`` is the COO plan's ``RowOrder``, the COO row kernel's
    launch order over the whole group. Hand-built plans may leave either
    None (``stack_plans`` builds ``coo_rows`` from the COO plan).
    """

    dense: SegmentPlan   # dense tile products -> row tiles (over tile_row)
    ell: SegmentPlan     # ELL unit rows -> padded rows (sentinel dropped)
    coo: SegmentPlan     # COO products -> padded rows
    ell_bucket_k: object = None   # [U] int32 bucket K ("fused"/"loop")
    coo_rows: object = None       # RowOrder of ``coo`` (the COO kernel)


def segment_plan(dest: np.ndarray, n_segments: int,
                 keep: np.ndarray = None) -> SegmentPlan:
    """Host (numpy) plan summing entries ``keep`` by destination ``dest``."""
    dest = np.asarray(dest, np.int64).reshape(-1)
    idx = (np.arange(dest.size) if keep is None
           else np.flatnonzero(np.asarray(keep).reshape(-1)))
    order = idx[np.argsort(dest[idx], kind="stable")]
    lengths = np.bincount(dest[idx], minlength=n_segments)
    return SegmentPlan(order=order.astype(np.int64),
                       lengths=lengths.astype(np.int64), n_entries=dest.size,
                       offsets=segment_offsets(lengths),
                       live=segment_live([lengths]))


def _first_of_each(keys: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    """``True`` except on candidate entries whose key repeats an earlier
    candidate's key."""
    keep = np.ones(keys.shape[0], bool)
    cand = np.flatnonzero(candidates)
    if cand.size:
        _, first = np.unique(keys[cand], axis=0, return_index=True)
        keep[cand] = False
        keep[cand[first]] = True
    return keep


def _ell_plan(rows: np.ndarray, meta: PartitionMeta) -> SegmentPlan:
    rows = np.asarray(rows, np.int64).reshape(-1)
    return segment_plan(rows, meta.n_padded_rows,
                        rows != meta.ell_sentinel_row)


def bucket_runs(u: int, kmax: int, segments=()) -> tuple:
    """The fixed-K buckets ((K, n_units), ...) of a ``u``-unit array, as
    ``ell_buckets`` cuts it (one Kmax bucket without ``segments``)."""
    return tuple((k, sl.stop - sl.start)
                 for k, sl in _bucket_slices(u, kmax, segments))


def bucket_bounds(u: int, kmax: int, segments=()) -> np.ndarray:
    """[U] int32: the K of each unit's bucket (``bucket_runs``)."""
    runs = bucket_runs(u, kmax, segments)
    return np.repeat([k for k, _ in runs],
                     [n for _, n in runs]).astype(np.int32)


def bucket_plan(rows, meta: PartitionMeta, device=None) -> SegmentPlan:
    """The "loop" reduction of one bucket's rows [(G,) N]: per padded
    row, the running buffer's value first (entries ``0 .. P - 1`` of a
    member), then the bucket's entries in unit order (``P + i``). Applied
    bucket after bucket from a zero buffer, this adds every entry in the
    order of one sequential scatter-add per bucket (the reference's
    "loop"). Placed on ``device`` when given."""
    r = to_numpy(rows).astype(np.int64)
    plan = _stack_segments([_bucket_plan(m, meta)
                            for m in r.reshape(-1, r.shape[-1])])
    return plan if device is None else _segments_to(plan, device)


def _bucket_plan(rows: np.ndarray, meta: PartitionMeta) -> SegmentPlan:
    br = np.asarray(rows, np.int64).reshape(-1)
    p = meta.n_padded_rows
    return segment_plan(
        np.concatenate([np.arange(p), br]), p,
        np.concatenate([np.ones(p, bool), br != meta.ell_sentinel_row]))


def _member_plan(part: TriPartition, meta: PartitionMeta) -> ReductionPlan:
    """Host reduction plan of one (unstacked) partition.

    Class padding appends all-zero dense tiles on (row tile 0, col tile
    0) and (row 0, col 0, +0.0) COO triples, which all land on output
    row block 0. Every such duplicate adds the same value ``0 * B[...]``
    (±0, or NaN where B is not finite), and adding one value of that
    kind a second time never changes a sum, so the plan keeps the first
    of each identical duplicate and drops the rest: the result is
    bit-identical to summing them all, without a serial chain thousands
    of entries long on row 0.
    """
    tiles = to_numpy(part.dense.tiles).astype(np.float32)
    n_t = tiles.shape[0]
    trow = to_numpy(part.dense.tile_row).astype(np.int64)
    tcol = to_numpy(part.dense.tile_col).astype(np.int64)
    zero_tile = ~np.ascontiguousarray(tiles).reshape(
        n_t, int(np.prod(tiles.shape[1:]))).view(np.uint32).any(1)
    dense = segment_plan(trow, meta.n_row_tiles, _first_of_each(
        np.stack([trow, tcol], 1), zero_tile))

    ell_rows = to_numpy(part.ell.rows)
    ell = _ell_plan(ell_rows, meta)

    crow = to_numpy(part.coo.rows).astype(np.int64)
    ccol = to_numpy(part.coo.cols).astype(np.int64)
    pos_zero = np.ascontiguousarray(
        to_numpy(part.coo.vals), np.float32).view(np.uint32) == 0
    coo = segment_plan(crow, meta.n_padded_rows, _first_of_each(
        np.stack([crow, ccol], 1), pos_zero))
    return ReductionPlan(dense, ell, coo, bucket_bounds(
        part.ell.cols.shape[-3], part.ell.cols.shape[-1], meta.ell_segments))


def _stack_segments(segs) -> SegmentPlan:
    n = segs[0].n_entries
    member_lengths = [to_numpy(s.lengths) for s in segs]
    lengths = np.concatenate(member_lengths)
    return SegmentPlan(
        order=np.concatenate([to_numpy(s.order) + g * n
                              for g, s in enumerate(segs)]),
        lengths=lengths, n_entries=n, offsets=segment_offsets(lengths),
        live=segment_live(member_lengths))


def stack_plans(plans) -> ReductionPlan:
    """Concatenate members' plans into one plan over a group axis."""
    dense, ell, coo = (_stack_segments([p[i] for p in plans])
                       for i in range(3))
    return ReductionPlan(dense, ell, coo, ell_bucket_k=plans[0].ell_bucket_k,
                         coo_rows=row_order(coo.lengths))


def reduction_plan(part: TriPartition, meta: PartitionMeta,
                   device=None) -> ReductionPlan:
    """The partition's reduction plan, built on the host with numpy.

    ``part`` may carry a leading group axis; the plan then covers the
    whole group. With ``device`` the plan's index tensors are placed
    there (else they stay numpy).
    """
    members = [part]
    if part.dense.tiles.ndim == 4:
        g = part.dense.tiles.shape[0]
        members = [TriPartition(*(type(c)(*(a[i] for a in c)) for c in part))
                   for i in range(g)]
    plan = stack_plans([_member_plan(m, meta) for m in members])
    return plan if device is None else plan_to(plan, device)


def _segments_to(seg: SegmentPlan, device) -> SegmentPlan:
    return SegmentPlan(_to_tensor(seg.order, np.int64, device),
                       _to_tensor(seg.lengths, np.int64, device),
                       seg.n_entries,
                       _to_tensor(seg.offsets, np.int64, device),
                       _to_tensor(seg.live, np.int64, device))


def plan_to(plan: ReductionPlan, device) -> ReductionPlan:
    rows = plan.coo_rows
    return ReductionPlan(
        *(_segments_to(s, device) for s in plan[:3]),
        ell_bucket_k=(None if plan.ell_bucket_k is None else _to_tensor(
            plan.ell_bucket_k, np.int32, device)),
        coo_rows=None if rows is None else RowOrder(
            _to_tensor(rows.rows, np.int64, device), rows.at_least))


class IdentityCache:
    """Values built from arrays the caller passes (numpy arrays or
    tensors), kept while those arrays live: the host-built plans of one
    graph are built once however many steps use them.

    An entry is keyed on the identity of its arrays and a hashable
    ``tag``, and goes when one of its arrays is freed. Arrays that take
    no weak reference are not cached.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}

    def get(self, arrays: tuple, tag, build):
        key = (tuple(id(a) for a in arrays), tag)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and all(r() is a
                                       for r, a in zip(hit[0], arrays)):
                return hit[1]
            value = build()

            def evict(_, key=key, entries=self._entries):
                entries.pop(key, None)

            try:
                refs = [weakref.ref(a, evict) for a in arrays]
            except TypeError:
                return value
            self._entries[key] = (refs, value)
            return value

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def segment_sum(data: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Sum the plan's entries of ``data`` [G * n_entries, D] per segment,
    in the plan's fixed order. Returns [G * n_segments, D].

    ``torch.segment_reduce`` runs each (segment, column) sum as one
    sequential loop: no atomics, so the bits repeat from run to run.
    """
    n_seg = plan.lengths.shape[0]
    if plan.order.shape[0] == 0:
        return data.new_zeros((n_seg, data.shape[1]))
    return torch.segment_reduce(data.index_select(0, plan.order), "sum",
                                lengths=plan.lengths, axis=0, unsafe=True)


def scatter_ell_partials(rows, partials, meta: PartitionMeta, *,
                         plan=None) -> torch.Tensor:
    """Reduce flattened ELL partial products onto padded output rows.

    ``rows`` [(G,) N] holds global output-row ids, with padded unit rows
    carrying ``meta.ell_sentinel_row``; ``partials`` is [(G,) N, F].
    Entries bound for the sentinel row are never read, so callers
    receive exactly [(G,) n_padded_rows, F]. The sum per row runs in
    unit order, fixed by ``plan`` (a ``SegmentPlan``; built from ``rows``
    when not given).

    ``rows`` and ``partials`` may instead be aligned lists, one entry
    per bucket (the "loop" dispatch): one reduction per bucket into the
    same running buffer, in bucket order, through ``plan`` = the
    buckets' plans (``bucket_plan`` of each; built when not given).
    """
    if isinstance(partials, (list, tuple)):
        return _scatter_buckets(rows, partials, meta, plan)
    grouped = partials.dim() == 3
    if not grouped:
        rows, partials = rows[None], partials[None]
    g, n, f = partials.shape
    if plan is None:
        r = to_numpy(rows)
        plan = _segments_to(_stack_segments(
            [_ell_plan(r[i], meta) for i in range(g)]), partials.device)
    out = segment_sum(partials.reshape(g * n, f), plan)
    out = out.reshape(g, meta.n_padded_rows, f)
    return out if grouped else out[0]


def _scatter_buckets(rows, partials, meta: PartitionMeta, plans):
    grouped = partials[0].dim() == 3
    if not grouped:
        rows, partials = [r[None] for r in rows], [p[None] for p in partials]
    g, _, f = partials[0].shape
    if plans is None:
        plans = [bucket_plan(r, meta, partials[0].device) for r in rows]
    if len(plans) != len(partials):
        raise ValueError(f"{len(plans)} bucket plans for {len(partials)} "
                         "buckets")
    p = meta.n_padded_rows
    out = partials[0].new_zeros((g, p, f))
    for pp, plan in zip(partials, plans):
        data = torch.cat([out, pp], dim=1)
        out = segment_sum(data.reshape(-1, f), plan).reshape(g, p, f)
    return out if grouped else out[0]


# -------------------------------------------------------------- host CSR ----
def csr_from_dense(a: np.ndarray) -> CSRMatrix:
    """Build a host CSR from a dense numpy matrix (tests / small graphs)."""
    import scipy.sparse as sp

    m = sp.csr_matrix(a.astype(np.float32))
    return CSRMatrix(
        indptr=m.indptr.astype(np.int64),
        indices=m.indices.astype(np.int32),
        data=m.data.astype(np.float32),
        shape=m.shape,
    )


def csr_from_scipy(m) -> CSRMatrix:
    m = m.tocsr().astype(np.float32)
    m.sum_duplicates()
    return CSRMatrix(
        indptr=m.indptr.astype(np.int64),
        indices=m.indices.astype(np.int32),
        data=m.data.astype(np.float32),
        shape=m.shape,
    )


def csr_to_scipy(m: CSRMatrix):
    import scipy.sparse as sp

    return sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)


def partition_to_dense(part: TriPartition, meta: PartitionMeta) -> np.ndarray:
    """Reassemble A from its tri-partition (correctness oracle for tests)."""
    T = meta.tile
    out = np.zeros((meta.n_row_tiles * T, meta.n_col_tiles * T), np.float32)

    tiles = to_numpy(part.dense.tiles)
    trow = to_numpy(part.dense.tile_row)
    tcol = to_numpy(part.dense.tile_col)
    for t in range(tiles.shape[0]):
        r, c = int(trow[t]) * T, int(tcol[t]) * T
        out[r: r + T, c: c + T] += tiles[t]

    pad_row = meta.n_row_tiles * T
    cols = to_numpy(part.ell.cols)
    vals = to_numpy(part.ell.vals)
    rows = to_numpy(part.ell.rows)
    bcol = to_numpy(part.ell.tile_col)
    unit_k = to_numpy(part.ell.unit_k)
    n_units, R, _ = cols.shape
    for u in range(n_units):
        c0 = int(bcol[u]) * T
        for r in range(R):
            gr = int(rows[u, r])
            if gr >= pad_row:
                continue
            for k in range(int(unit_k[u])):
                v = vals[u, r, k]
                if v != 0.0:
                    out[gr, c0 + cols[u, r, k]] += v

    np.add.at(out, (to_numpy(part.coo.rows), to_numpy(part.coo.cols)),
              to_numpy(part.coo.vals))
    return out[: meta.n_rows, : meta.n_cols]
