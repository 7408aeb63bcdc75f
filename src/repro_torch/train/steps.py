"""train_step / serve_step factories, the GNN part (port of
``repro.train.steps``).

A train step takes ``(params, opt_state, batch)`` and returns the new
``(params, opt_state, {"loss": loss})``, as the reference's: the loss
and its gradient (``torch.autograd.grad``, the reference's
``jax.value_and_grad``), then the optimizer's update. Parameters are
trees of tensors and are never changed in place.

``make_hybrid_gcn_train_step`` is the paper's own training loop
(``examples/quickstart.py`` and ``tests/test_system.py`` of the
reference write it inline): the 2-layer GCN through the tri-hybrid
executor (``core.hybrid_spmm.gcn_forward``), whose backward runs the
same engines over Aᵀ.

DimeNet and NequIP, and the LM and FM factories, wait until their
models are ported.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core.hybrid_spmm import gcn_forward as hybrid_gcn_forward
from repro_torch.models import gnn as gnn_m

from repro_torch.tree import tree_leaves, tree_unflatten

UNPORTED = ("dimenet", "nequip")


def _unported(kind: str):
    raise NotImplementedError(f"{kind!r} is not ported to repro_torch yet")


def gnn_apply(params, graph, cfg: GNNConfig, constrain=None, gops=None,
              remat=False):
    if cfg.kind == "gcn":
        return gnn_m.gcn_forward(params, graph, cfg, constrain=constrain,
                                 gops=gops)
    if cfg.kind == "gatedgcn":
        return gnn_m.gatedgcn_forward(params, graph, cfg,
                                      constrain=constrain, gops=gops,
                                      remat=remat)
    if cfg.kind == "meshgraphnet":
        return gnn_m.meshgraphnet_forward(params, graph, cfg,
                                          constrain=constrain, gops=gops,
                                          remat=remat)
    if cfg.kind in UNPORTED:
        _unported(cfg.kind)
    raise ValueError(cfg.kind)


def masked_xent(logits, labels, mask=None) -> torch.Tensor:
    """Mean cross-entropy over the nodes of ``mask`` (all without one):
    ``sum((logsumexp - logit[label]) * mask) / max(sum(mask), 1)``.
    The label's logit is picked with a one-hot product, so the backward
    scatters nothing."""
    logits = logits.to(torch.float32)
    labels = torch.as_tensor(labels, device=logits.device).long()
    mask = (torch.ones(labels.shape[0], device=logits.device)
            if mask is None
            else torch.as_tensor(mask, device=logits.device)
            ).to(torch.float32)
    lz = torch.logsumexp(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(torch.clamp(labels, min=0),
                                         logits.shape[-1])
    tgt = (logits * onehot.to(logits.dtype)).sum(-1)
    return torch.sum((lz - tgt) * mask) / torch.clamp(mask.sum(), min=1.0)


def gnn_node_loss(params, batch, cfg: GNNConfig, constrain=None,
                  gops=None, remat=False):
    """Masked node-classification xent (padding-safe)."""
    graph = gnn_m.Graph(batch["senders"], batch["receivers"],
                        batch["node_feat"], batch.get("edge_feat"))
    logits = gnn_apply(params, graph, cfg, constrain=constrain, gops=gops,
                       remat=remat)
    return masked_xent(logits, batch["labels"], batch.get("node_mask"))


def value_and_grad(loss_fn, params, *args):
    """(loss, grads): ``loss_fn(params, *args)`` and its gradient in the
    tree of ``params`` (``jax.value_and_grad``); a parameter the loss
    does not reach gets zeros, as in JAX."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])


def _train_step(loss_fn, optimizer, compress=None):
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        if compress is not None:
            grads = compress(grads)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}
    return train_step


def make_gnn_train_step(cfg: GNNConfig, optimizer, compress=None,
                        constrain=None, gops=None, remat=False):
    if cfg.kind in UNPORTED:
        _unported(cfg.kind)
    loss_fn = functools.partial(gnn_node_loss, cfg=cfg, constrain=constrain,
                                gops=gops, remat=remat)
    return _train_step(loss_fn, optimizer, compress)


def make_gnn_serve_step(cfg: GNNConfig, n_mols: int = 1):
    if cfg.kind in UNPORTED:
        _unported(cfg.kind)

    @torch.no_grad()
    def serve_step(params, batch):
        graph = gnn_m.Graph(batch["senders"], batch["receivers"],
                            batch["node_feat"], batch.get("edge_feat"))
        return gnn_apply(params, graph, cfg)
    return serve_step


# ------------------------------------------------- the paper's own GCN ----
def hybrid_gcn_loss(weights, batch, *, part, **forward_kw):
    """Masked xent of the tri-hybrid GCN: ``batch`` holds ``x`` [N, F],
    ``labels`` [N] and ``mask`` [N]; ``forward_kw`` goes to
    ``core.hybrid_spmm.gcn_forward`` (meta, and backend, ell_dispatch,
    plan, ell_tune, device)."""
    logits = hybrid_gcn_forward(part, batch["x"], weights, **forward_kw)
    return masked_xent(logits, batch["labels"], batch["mask"])


def make_hybrid_gcn_train_step(part, optimizer, **forward_kw):
    """The paper's training step: ``step(weights, opt_state, batch)``
    over one preprocessed graph (``part``; ``forward_kw`` as for
    ``hybrid_gcn_loss``, its ``meta`` included), weights a list of
    [F_in, F_out] tensors. On the ``cuda`` backend both the forward and
    the backward run the hand kernels (the backward over Aᵀ's partition,
    built at the first step)."""
    loss_fn = functools.partial(hybrid_gcn_loss, part=part, **forward_kw)
    return _train_step(loss_fn, optimizer)
