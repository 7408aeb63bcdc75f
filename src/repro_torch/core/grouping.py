"""Algorithm 1 — moving-average row grouping (paper §IV-C, Fig. 6).

Port of ``repro.core.grouping`` (host numpy, unchanged arithmetic).
Rows of a sparse matrix are walked in order; a running moving average of
nnz-per-row is maintained, and whenever the relative change of the moving
average exceeds a threshold tau a new group is started. Every row in a
group is then padded to the group's max nnz, giving *fixed inner trip
counts* for the sparse engine.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


class MovingAverage:
    """Windowed moving average with reset (the paper's MovingAverage()).

    A windowed (not cumulative) average keeps the detector responsive: a
    cumulative mean over a long prefix dampens nnz jumps so badly that a
    2->40 step never exceeds any reasonable tau.
    """

    def __init__(self, window: int = 8):
        self.window = window
        self._buf: list = []

    def update(self, x: float) -> float:
        self._buf.append(float(x))
        if len(self._buf) > self.window:
            self._buf.pop(0)
        return sum(self._buf) / len(self._buf)

    def reset(self):
        self._buf.clear()

    @property
    def value(self) -> float:
        return 0.0 if not self._buf else sum(self._buf) / len(self._buf)


@dataclasses.dataclass(frozen=True)
class Group:
    """A contiguous run of rows padded to a common nnz width."""

    start: int      # first row (inclusive)
    stop: int       # last row (exclusive)
    k: int          # padded nnz per row = max nnz in the group

    @property
    def n_rows(self) -> int:
        return self.stop - self.start

    @property
    def padded_nnz(self) -> int:
        return self.n_rows * self.k


def group_rows(nnz_rows: Sequence[int], tau: float = 0.5,
               window: int = 8) -> list:
    """Algorithm 1. Returns a list of Groups covering [0, len(nnz_rows)).

    Rows with zero nnz still belong to a group (k may be 0 => the group
    is a no-op).
    """
    nnz_rows = np.asarray(nnz_rows, dtype=np.int64)
    rows = len(nnz_rows)
    groups: list = []
    if rows == 0:
        return groups

    ma = MovingAverage(window)
    g_start = 0
    cur_ave = 0.0
    for i in range(rows):
        pre_ave = cur_ave
        cur_ave = ma.update(nnz_rows[i])
        if pre_ave == 0.0:
            pre_ave = cur_ave  # prevent division by zero (paper line 11)
        if pre_ave > 0.0 and abs(cur_ave - pre_ave) / pre_ave >= tau:
            # close the group [g_start, i) and restart the moving average
            if i > g_start:
                k = int(nnz_rows[g_start:i].max(initial=0))
                groups.append(Group(g_start, i, k))
            g_start = i
            ma.reset()
            cur_ave = ma.update(nnz_rows[i])
    k = int(nnz_rows[g_start:rows].max(initial=0))
    groups.append(Group(g_start, rows, k))
    return groups


def grouping_density(nnz_rows: Sequence[int], groups: Sequence[Group]) -> float:
    """Real nnz / padded nnz over all groups (paper: `calc_density`)."""
    nnz_rows = np.asarray(nnz_rows, dtype=np.int64)
    real = int(nnz_rows.sum())
    padded = sum(g.padded_nnz for g in groups)
    return 1.0 if padded == 0 else real / padded


def padded_ops(nnz_rows: Sequence[int], groups: Sequence[Group]) -> int:
    """Number of MACs actually executed after padding (cost-model input)."""
    return sum(g.padded_nnz for g in groups)


def groups_cover_exactly(groups: Sequence[Group], rows: int) -> bool:
    """Invariant check: groups tile [0, rows) exactly once, in order."""
    pos = 0
    for g in groups:
        if g.start != pos or g.stop <= g.start:
            return False
        pos = g.stop
    return pos == rows
