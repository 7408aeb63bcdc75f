"""Shared building blocks for the model zoo (port of
``repro.models.common``).

Initializers draw from an explicit ``torch.Generator`` (the reference's
``jax.random`` keys), on the generator's device. The gather and segment
sum that message passing and ``embedding_bag`` use are deterministic in
both directions: ``take`` is ``index_select`` whose backward sums the
cotangent per source row by a host-built ``SegmentPlan``, and
``segment_sum`` sums by plan and gathers in its backward. Neither uses
``index_add_``/``scatter_add_``, whose atomics add in another order on
every run of the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import (IdentityCache, _segments_to,
                                      plan_index, segment_plan)
from repro_torch.core.formats import segment_sum as _plan_sum
from repro_torch.tree import tree_leaves


def uniform_init(gen: torch.Generator, shape, scale=None,
                 dtype=torch.float32):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return u * (2 * s) - s


def normal_init(gen: torch.Generator, shape, stddev=0.02,
                dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * stddev


def one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(ids, n)`` (int64) as a comparison with the class ids:
    the same ops on real and on fake tensors (``F.one_hot`` checks the
    range of real ids with a reduction, and fake ones it expands into a
    comparison), so the dry-run's trace counts the ops a step runs.
    ``ids`` must lie in ``[0, n)``."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def rms_norm(x, scale, eps=1e-6):
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def mlp(x, params, activation=torch.relu, final_activation=False):
    """Simple MLP: params = [(w, b), ...]."""
    n = len(params)
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if i < n - 1 or final_activation:
            x = activation(x)
    return x


def init_mlp(gen: torch.Generator, dims, dtype=torch.float32):
    return [(uniform_init(gen, (di, do), dtype=dtype),
             torch.zeros((do,), dtype=dtype, device=gen.device))
            for di, do in zip(dims[:-1], dims[1:])]


# ----------------------------------------------------------------- RoPE ----
def apply_rope(x, positions, theta: float = 1e6):
    """Rotary embedding computed on the fly. x [..., S, H, D]; positions
    broadcastable to [..., S]."""
    d = x.shape[-1]
    inv = torch.as_tensor(1.0 / (theta ** (np.arange(0, d, 2) / d)),
                          dtype=torch.float32, device=x.device)
    freqs = torch.as_tensor(positions, device=x.device)[..., None].to(
        torch.float32) * inv                                 # [..., S, D/2]
    c = torch.cos(freqs)[..., None, :]                       # [..., S, 1, D/2]
    s = torch.sin(freqs)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------- segment ops (GNN/FM) ----
# host SegmentPlans of index arrays, built once per index array
_PLANS = IdentityCache()


def _plan(idx, n: int, device):
    def build():
        dest = plan_index(idx, n).astype(np.int64).reshape(-1)
        return _segments_to(segment_plan(dest, int(n)), device)
    return _PLANS.get((idx,), (int(n), str(device)), build)


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, device=device).long()


def _summed(data: torch.Tensor, plan, n: int) -> torch.Tensor:
    e = data.shape[0]
    out = _plan_sum(data.reshape(e, -1), plan)
    return out.reshape((n,) + tuple(data.shape[1:]))


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, plan):
        ctx.plan, ctx.n = plan, x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _summed(g.contiguous(), ctx.plan, ctx.n), None, None


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, idx, plan, n):
        ctx.save_for_backward(idx)
        return _summed(v.contiguous(), plan, n)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g.index_select(0, idx), None, None, None


def take(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[idx]`` along axis 0 (``jnp.take(x, idx, axis=0)``); its
    gradient sums onto x's rows by plan. Where no gradient is recorded
    (serving, decode) no plan is built: the gather alone."""
    i = _index(idx, x.device)
    shape = tuple(i.shape) + tuple(x.shape[1:])
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.index_select(0, i.reshape(-1)).reshape(shape)
    plan = _plan(idx, x.shape[0], x.device)
    return _Take.apply(x, i.reshape(-1), plan).reshape(shape)


def segment_sum(v: torch.Tensor, idx, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(v, idx, num_segments=n)``, each segment's
    entries added in index order from +0 (a ``SegmentPlan``); its
    gradient gathers the cotangent at ``idx``."""
    plan = _plan(idx, n, v.device)
    return _SegmentSum.apply(v, _index(idx, v.device), plan, int(n))


def segment_max(v: torch.Tensor, idx, n: int) -> torch.Tensor:
    """``jax.ops.segment_max``: -inf for an empty segment."""
    i = _index(idx, v.device)
    i = i.reshape((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
    out = v.new_full((n,) + tuple(v.shape[1:]), float("-inf"))
    return out.scatter_reduce(0, i, v, "amax", include_self=True)


def segment_softmax(logits, segment_ids, num_segments):
    mx = segment_max(logits, segment_ids, num_segments)
    ex = torch.exp(logits - take(mx, segment_ids))
    den = segment_sum(ex, segment_ids, num_segments)
    return ex / (take(den, segment_ids) + 1e-9)


def embedding_bag(table, indices, offsets=None, mode="sum"):
    """torch.nn.EmbeddingBag equivalent, as the reference builds it:
    gather + segment sum. indices [N] flat ids; offsets [B] bag starts
    (None -> one id per bag)."""
    if offsets is None:
        return take(table, indices)
    n = int(np.asarray(indices.shape[0]))
    offsets = plan_index(offsets, n).astype(np.int64)
    bag_ids = np.zeros(n, np.int64)
    if offsets.shape[0] > 1:
        np.add.at(bag_ids, offsets[1:], 1)
        bag_ids = np.cumsum(bag_ids)
    bags = torch.from_numpy(bag_ids)
    emb = take(table, indices)
    out = segment_sum(emb, bags, offsets.shape[0])
    if mode == "mean":
        cnt = segment_sum(torch.ones(n, device=emb.device), bags,
                          offsets.shape[0])
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def count_params(params) -> int:
    return sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(params))
