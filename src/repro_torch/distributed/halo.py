"""Locality-aware distributed gather/scatter for 1-D sharded graph tensors
(port of ``repro.distributed.halo``).

The paper's graph reordering (§IV-B) concentrates edges near the diagonal;
in distributed terms: after reordering, an edge's endpoints live in the
same or a neighboring shard. These halo ops exchange only the two
neighboring shards, point to point (the reference's ``ppermute``): each
rank sends to its right neighbour and receives from its left, and the
reverse.

  memory   per rank: 3 shards instead of the full table
  traffic  per rank: 2 shards instead of n-1

Contract: after reordering, every gathered index lies within one shard
of its consumer's position. Indices outside the halo are clamped to it,
as in the reference (``clip(idx - base, 0, 3*shard - 1)``), which gives
wrong values for them: the reference's docstring promises an offline
partitioner that validates the bound and widens the halo, and no such
code exists there either. ``validate_locality`` measures the fraction.

The ops run per rank. ``take(x, idx)``: ``x`` is this rank's block of
rows, ``idx`` this rank's block of (global) row indices. ``segment_sum(
vals, idx, num_segments)``: ``num_segments`` is the number of segments
this rank holds. The shard of rank i is block i of the dimension sharded
over ``axes``, first axis major (``PartitionSpec(axes)``).

Both ops are ``torch.autograd.Function``s and are each other's
transpose, as JAX derives by transposing ``ppermute``: the backward of
``take`` is the halo ``segment_sum`` of the cotangent, the backward of
``segment_sum`` the halo ``take``. Every rank runs the same program, so
every rank reaches each exchange, forward and backward, in the same
order. The local sum is the port's plan-ordered ``segment_sum`` (no
atomics), and a sum arriving from the neighbours is added in the
reference's order, ``center + from_left + from_right``.

The exchange is ``batch_isend_irecv`` with the message to the right
first: where the left and the right neighbour are one rank (2 shards)
the two messages are told apart by that order (NCCL ignores tags) and by
their tags (gloo). With one shard the exchange is with this rank
itself: NCCL takes a send to itself; gloo refuses one, so there the
block is copied, which moves the same bits.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.formats import (IdentityCache, _segments_to,
                                      plan_index, segment_plan)
from repro_torch.core.formats import segment_sum as _plan_sum
from repro_torch.launch.mesh import axes_group, ring

TAG_RIGHT, TAG_LEFT = 7101, 7102


class _Exchange:
    """Point-to-point exchange with the two neighbouring shards."""

    def __init__(self, ranks, me: int):
        n = len(ranks)
        self.left, self.right = ranks[(me - 1) % n], ranks[(me + 1) % n]
        self.self_copy = (n == 1 and dist.get_backend() == "gloo")
        self.calls = 0

    def __call__(self, to_right: torch.Tensor, to_left: torch.Tensor):
        """(from_left, from_right): ``to_right`` goes to the right
        neighbour, which receives it as its ``from_left``."""
        self.calls += 1
        to_right, to_left = to_right.contiguous(), to_left.contiguous()
        if self.self_copy:
            return to_right.clone(), to_left.clone()
        from_left = torch.empty_like(to_right)
        from_right = torch.empty_like(to_left)
        ops = [dist.P2POp(dist.isend, to_right, self.right, tag=TAG_RIGHT),
               dist.P2POp(dist.irecv, from_left, self.left, tag=TAG_RIGHT),
               dist.P2POp(dist.isend, to_left, self.left, tag=TAG_LEFT),
               dist.P2POp(dist.irecv, from_right, self.right, tag=TAG_LEFT)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return from_left, from_right


class HaloOps(tuple):
    """``(take, segment_sum)``, as ``make_halo_ops`` returns them, with
    the process ``group`` of the mesh axes and the ``exchange`` (whose
    ``calls`` counts exchanges) attached: the sharded train step reads
    ``group`` to sum the loss and the gradients."""

    def __new__(cls, take, segment_sum, *, group, exchange):
        self = super().__new__(cls, (take, segment_sum))
        self.group, self.exchange = group, exchange
        return self


def make_halo_ops(mesh, axes) -> HaloOps:
    """Returns (take_fn, segment_sum_fn) bound to ``mesh`` over ``axes``.
    Collective where ``axes`` are several (their group is made here):
    every rank of the mesh calls."""
    axes = tuple(axes)
    ranks, me = ring(mesh, axes)
    exchange = _Exchange(ranks, me)
    locs = IdentityCache()

    def local(il, shard: int, device):
        """(loc, plan) of an index block: the clamped halo position of
        each index and the plan that sums onto the 3 * shard halo rows."""
        def build():
            base = me * shard - shard
            loc = np.clip(plan_index(il, 3 * shard).astype(np.int64)
                          .reshape(-1) - base, 0, 3 * shard - 1)
            plan = _segments_to(segment_plan(loc, 3 * shard), device)
            return torch.as_tensor(loc, device=device), plan
        return locs.get((il,), (int(shard), str(device)), build)

    def halo_take(x, loc):
        from_left, from_right = exchange(x, x)
        halo = torch.cat([from_left, x, from_right], dim=0)
        return halo.index_select(0, loc)

    def halo_sum(vals, plan, shard: int):
        e = vals.shape[0]
        acc = _plan_sum(vals.reshape(e, -1).contiguous(), plan)
        acc = acc.reshape((3 * shard,) + tuple(vals.shape[1:]))
        left, center, right = acc[:shard], acc[shard:2 * shard], \
            acc[2 * shard:]
        # my 'left' block belongs to my left neighbour and vice versa
        from_left, from_right = exchange(right, left)
        return center + from_left + from_right

    class Take(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, loc, plan):
            ctx.loc, ctx.plan, ctx.shard = loc, plan, x.shape[0]
            return halo_take(x, loc)

        @staticmethod
        @torch.autograd.function.once_differentiable
        def backward(ctx, g):
            return halo_sum(g, ctx.plan, ctx.shard), None, None

    class SegmentSum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, vals, loc, plan, shard):
            ctx.loc = loc
            return halo_sum(vals, plan, shard)

        @staticmethod
        @torch.autograd.function.once_differentiable
        def backward(ctx, g):
            return halo_take(g.contiguous(), ctx.loc), None, None, None

    def take(x, idx):
        """x [shard, ...] this rank's rows; idx [m] (global row ids, this
        rank's block). Returns x[idx] assuming halo locality."""
        shard = x.shape[0]
        loc, plan = local(idx, shard, x.device)
        return Take.apply(x, loc, plan)

    def segment_sum(vals, idx, num_segments):
        """segment_sum(vals [m, ...], idx [m]) -> [num_segments, ...], this
        rank's segments, with halo locality on idx."""
        shard = int(num_segments)
        loc, plan = local(idx, shard, vals.device)
        return SegmentSum.apply(vals, loc, plan, shard)

    return HaloOps(take, segment_sum, group=axes_group(mesh, axes),
                   exchange=exchange)


def validate_locality(idx: np.ndarray, positions: np.ndarray, n_total: int,
                      nshards: int) -> float:
    """Offline check: fraction of references outside the +-1-shard halo
    (the partitioner warns/widens if > 0)."""
    shard = n_total // nshards
    return float(np.mean(np.abs(idx - positions) > shard))
