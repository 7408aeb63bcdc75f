"""Optimizers from scratch: AdamW + SGD-momentum, global-norm clipping,
warmup-cosine schedule.

Port of ``repro.train.optimizer``: the same arithmetic as pure
functions of parameter trees (dicts, lists, tuples of tensors; see
``repro_torch.tree``). ``update`` returns new tensors and leaves
its arguments as they are, as the reference's pytree transforms do.
Everything is elementwise or a whole-tensor sum, so an update repeats
bit for bit on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: dict


def _step_zero(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p), params)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        return AdamWState(_step_zero(params), _zeros(params), _zeros(params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, norm_reduce=None):
        """``norm_reduce``: the clipping norm's reduction over ranks
        (``global_norm``); None on one rank."""
        step = state.step + 1
        if self.clip_norm:
            grads = clip_by_global_norm(grads, self.clip_norm, norm_reduce)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                      state.nu, grads)
        sf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, sf)
        bc2 = 1 - torch.pow(b2, sf)
        lr = self._lr(step)

        def upd(p, m, v):
            mhat = m / bc1
            vhat = v / bc2
            return (p - lr * (mhat / (torch.sqrt(vhat) + self.eps)
                              + self.weight_decay * p)).to(p.dtype)

        return tree_map(upd, params, mu, nu), AdamWState(step, mu, nu)


class SGDState(NamedTuple):
    step: torch.Tensor
    mom: dict


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Callable | float = 1e-2
    momentum: float = 0.9
    clip_norm: float = 0.0

    def init(self, params) -> SGDState:
        return SGDState(_step_zero(params), _zeros(params))

    @torch.no_grad()
    def update(self, grads, state: SGDState, params, norm_reduce=None):
        if self.clip_norm:
            grads = clip_by_global_norm(grads, self.clip_norm, norm_reduce)
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        mom = tree_map(lambda m, g: self.momentum * m + g, state.mom, grads)
        new_params = tree_map(lambda p, m: (p - lr * m).to(p.dtype),
                              params, mom)
        return new_params, SGDState(step, mom)


def global_norm(tree, reduce=None) -> torch.Tensor:
    """The L2 norm of every leaf together. ``reduce``: for leaves that
    are this rank's blocks of sharded tensors, a function from the
    per-leaf sums of squares (in leaf order) to each whole leaf's
    (``distributed.tp.LMPlan.norm_reduce``: each distinct block counted
    once, a replicated leaf once); the sums are then added in leaf order
    as without it."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    if reduce is not None:
        sq = reduce(sq)
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads, max_norm: float, reduce=None):
    n = global_norm(grads, reduce)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    def schedule(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup, warm, cos)
    return schedule
