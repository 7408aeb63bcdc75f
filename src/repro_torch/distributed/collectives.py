"""Gradient compression with error feedback (port of
``repro.distributed.collectives``).

int8 quantization with a per-tensor scale and an error-feedback residual
(Seide et al. / EF-SGD): int8 cuts the bytes of a data-parallel
all-reduce 4x while error feedback keeps the convergence order. The
train-step factories take ``compress`` (a function of the gradient tree
alone), so a caller holds the ``EFState`` between steps in a closure:

    ef = ef_init(params)
    def compress(grads):
        nonlocal ef
        grads, ef = compress_with_error_feedback(grads, ef)
        return grads

``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
codes and scales are the reference's bits. The reference compresses the
gradients its step has already reduced (the global view's gradient), so
the hook runs after the data-parallel all-reduce here too; int8 on the
wire is not the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class EFState(NamedTuple):
    residual: dict           # same structure as grads


def ef_init(params) -> EFState:
    return EFState(tree_map(torch.zeros_like, params))


def quantize_int8(x: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_with_error_feedback(grads, ef: EFState):
    """Returns (compressed-then-decompressed grads, new EF state).

    The int8 round-trip models exactly what the wire sees; the residual
    (quantization error) is added back into the next step's gradient.
    """
    def one(g, r):
        corrected = g.to(torch.float32) + r
        q, scale = quantize_int8(corrected)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), corrected - deq

    outs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                      tree_leaves(ef.residual))]
    new_g = tree_unflatten(grads, [o[0] for o in outs])
    new_r = tree_unflatten(grads, [o[1] for o in outs])
    return new_g, EFState(new_r)


def overlap_flags() -> dict:
    """The compute/communication overlap knobs the sharded layer sets.

    These are not XLA's: the reference returns XLA's TPU scheduler flags
    (latency-hiding scheduler, async collective fusion), which nothing
    on CUDA reads. The port's sharded layer runs its collectives on the
    process group's own stream with the backends' defaults and sets no
    NCCL or gloo variable, so there is none to return."""
    return {}
