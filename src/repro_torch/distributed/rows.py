"""FM's embedding tables over a mesh: the two layouts of
``sharding.fm_param_specs``, and the lookup of rows split over ranks.

The reference gets both layouts from GSPMD. ``fm_param_specs`` splits
the rows of ``v`` and ``w`` over every mesh axis where the row count
divides (the (2, 2), (1, 4) and (4, 1) meshes of the tests), and
``fit_specs`` leaves them whole on every rank where it does not (FM's
32 580 500 rows on 16 x 16 and 2 x 16 x 16). The batch is split over the
data axes; the retrieval cell's candidates over every axis.

``FMShards`` runs the FM steps over a rank's blocks in either layout:

- whole tables: each rank looks up its block of the batch with
  ``models.common.take``; its share of the loss is its block's sum over
  the global batch size, and the loss and the gradients of ``v``, ``w``
  and ``w0`` are summed over the data axes;
- rows split: ``RowLookup``. The index is gathered over the axes it is
  split over; each rank gathers the rows it owns and writes zero for
  the rest, the result is summed over the ranks that split the rows,
  and each rank keeps its block. Every entry has one non-zero term, so
  the lookup equals the unsharded one exactly. The gradient of a rank's
  rows is summed by plan (the order of ``take``'s backward) from the
  cotangent gathered over the index's axes, so it is whole on each rank;
  the loss and ``w0``'s gradient are summed over the data axes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.formats import _segments_to, plan_index, segment_plan
from repro_torch.distributed.tp import _all_gather
from repro_torch.launch.mesh import all_axes, axes_group, data_axes
from repro_torch.models.common import _summed, take


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` along dim 0, in group-rank order
    (``x`` itself where there is no group)."""
    return x if group is None else _all_gather(x, 0, group)


class _RowLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, lookup):
        ids = _gather(idx, lookup.index_group)
        n = table.shape[0]
        loc = ids.long() - dist.get_rank(lookup.row_group) * n
        own = (loc >= 0) & (loc < n)
        rows = table.index_select(0, torch.where(own, loc, 0).reshape(-1))
        rows = rows.reshape(tuple(loc.shape) + tuple(table.shape[1:]))
        mask = own.reshape(tuple(own.shape) + (1,) * (table.dim() - 1))
        rows = torch.where(mask, rows, 0.0)
        dist.all_reduce(rows, group=lookup.row_group)
        ctx.loc, ctx.n, ctx.lookup = loc, n, lookup
        return lookup.block(rows)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        g_all = _gather(g, ctx.lookup.index_group)
        dest = plan_index(ctx.loc, ctx.n).reshape(-1)
        keep = (dest >= 0) & (dest < ctx.n)
        plan = _segments_to(segment_plan(dest, ctx.n, keep), g.device)
        return _summed(g_all.reshape(dest.shape[0], -1), plan,
                       ctx.n).reshape((ctx.n,) + tuple(g.shape[
                           ctx.loc.dim():])), None, None


class RowLookup:
    """``table[idx]`` of a table whose rows are split over every axis of
    ``mesh`` (this rank holds block ``rank(row group)``), with ``idx``
    (global row ids) split along its first dimension over
    ``index_axes`` (this rank holds block ``rank(index group)``; ``()``:
    whole on every rank). Returns this rank's block of the rows looked
    up. Collective over the mesh: every rank calls."""

    def __init__(self, mesh, index_axes: tuple):
        self.row_group = axes_group(mesh, all_axes(mesh))
        self.index_group = (axes_group(mesh, tuple(index_axes))
                            if index_axes else None)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        if self.index_group is None:
            return x
        n = x.shape[0] // dist.get_world_size(self.index_group)
        return x.narrow(0, dist.get_rank(self.index_group) * n, n)

    def __call__(self, table: torch.Tensor, idx) -> torch.Tensor:
        idx = torch.as_tensor(idx, device=table.device)
        return _RowLookup.apply(table, idx, self)


class FMShards:
    """How the FM cell's tables and batch lie over ``mesh``: ``rows``,
    the tables' rows split over every axis (else whole on every rank).
    Made where every rank runs the program: its groups are collective."""

    def __init__(self, mesh, rows: bool):
        self.rows = bool(rows)
        dp = data_axes(mesh)
        self.data_group = axes_group(mesh, dp) if dp else None
        self.batch = RowLookup(mesh, dp) if rows else take
        self.candidates = RowLookup(mesh, all_axes(mesh)) if rows else take
        self.context = RowLookup(mesh, ()) if rows else take

    def global_batch(self, labels) -> int:
        """The batch's size over the data axes (``labels`` this rank's
        block)."""
        n = int(labels.shape[0])
        return n * (dist.get_world_size(self.data_group)
                    if self.data_group is not None else 1)

    def summed(self, grads) -> dict:
        """The gradients whose shares are summed over the data axes:
        every leaf where the tables are whole, else ``w0``'s."""
        return dict(grads) if not self.rows else {"w0": grads["w0"]}
