"""train_step / serve_step factories for the LM, GNN and FM families
(port of ``repro.train.steps``).

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

The LM loss avoids materializing [B, S, V] logits with a
sequence-chunked cross-entropy, each chunk recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``). The LM
loss and train step take ``compute_dtype`` (default bf16, the
reference's fixed choice; None runs f32). Prefill, decode and the FM
serve steps record no gradient.

DimeNet and NequIP train on the mean squared error of per-molecule
energies (``energy_loss_dimenet`` / ``energy_loss_nequip``), sharded
too under the halo ops; their serve step returns the energies.

The GNNs train sharded too: ``make_gnn_train_step(cfg, opt,
gops=make_halo_ops(mesh, axes))`` runs on every rank of the mesh over
its shard of the graph, with the loss and the gradients summed over the
mesh (one all-reduce of one flat buffer) before ``compress`` and the
optimizer, as the reference's global-view program computes them.

The LM trains sharded over a (data, model) mesh:
``make_lm_train_step(cfg, opt, act_constraint=NamedSharding(mesh,
tp.residual_spec(cfg, mesh)))`` under the config's ``parallelism``
("tp_fsdp" or "fsdp"; ``distributed.tp.LMPlan``), as the reference's
train cells pass it, with the vocab-parallel cross-entropy where the
head is split over `model`.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import (GNNConfig, RecsysConfig,
                                      TransformerConfig)
from repro_torch.core.hybrid_spmm import gcn_forward as hybrid_gcn_forward
from repro_torch.models import dimenet as dimenet_m
from repro_torch.models import fm as fm_m
from repro_torch.models import gnn as gnn_m
from repro_torch.models import nequip as nequip_m
from repro_torch.models import transformer as tfm
from repro_torch.models.common import one_hot, take

from repro_torch.tree import tree_leaves, tree_unflatten


# ------------------------------------------------------------- LM ----------
def _xent_chunk(hc, lc, head, v0: int = 0, group=None):
    """(sum of token xent, count of labelled tokens) of one chunk, the
    head's vocabulary columns ``[v0, v0 + V_local)``. ``group``: the
    vocabulary is split over it (vocab-parallel cross-entropy): the max,
    the sum of exponentials and the label's logit are summed over it.
    One formula with or without a group: ``lz = max + log(sum(exp(l -
    max)))``. The label's logit is picked by a comparison with the
    vocabulary ids, so the backward scatters nothing."""
    from repro_torch.distributed import tp

    logits = (hc @ head).to(torch.float32)                # [B, c, V]
    mx = torch.amax(logits, dim=-1).detach()
    if group is not None:
        mx = tp.all_max(mx, group)
    ex = torch.sum(torch.exp(logits - mx[..., None]), dim=-1)
    vocab = torch.arange(v0, v0 + logits.shape[-1], device=logits.device)
    hit = vocab == torch.clamp(lc, min=0)[..., None]
    tgt = torch.where(hit, logits, 0.0).sum(dim=-1)
    if group is not None:
        ex, tgt = tp.sum_over(ex, group), tp.sum_over(tgt, group)
    lz = mx + torch.log(ex)
    valid = (lc >= 0).to(torch.float32)
    return torch.sum((lz - tgt) * valid), torch.sum(valid)


def _xent_sums(h, head, labels, *, chunk: int, v0: int = 0, group=None):
    """(sum of token xent, count of labelled tokens) over S chunks, each
    recomputed in the backward."""
    b, s, d = h.shape
    labels = torch.as_tensor(labels, device=h.device).long()
    c = min(chunk, s)
    sp = -(-s // c) * c
    hp = F.pad(h, (0, 0, 0, sp - s)) if sp > s else h
    lp = F.pad(labels, (0, sp - s), value=-1) if sp > s else labels
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    # with a group the recompute replays the whole chunk, its collectives
    # included
    with (set_checkpoint_early_stop(False) if group is not None
          else contextlib.nullcontext()):
        for i in range(sp // c):
            part, n = checkpoint(_xent_chunk, hp[:, i * c:(i + 1) * c],
                                 lp[:, i * c:(i + 1) * c], head, v0, group,
                                 use_reentrant=False)
            tot = tot + part
            cnt = cnt + n
    return tot, cnt


def chunked_cross_entropy(h, head, labels, *, chunk: int = 256):
    """Mean token xent without a full [B,S,V] logits tensor.

    h [B,S,D], head [D,V], labels [B,S] -> scalar. Loops over S chunks,
    each recomputed in the backward, so a chunk's [B,c,V] logits live
    only transiently; labels < 0 (the padded tail) do not count.
    """
    tot, cnt = _xent_sums(h, head, labels, chunk=chunk)
    return tot / torch.clamp(cnt, min=1.0)


def _sharded_xent(h, params, labels, plan, chunk: int):
    """The mean token xent of the global batch from this rank's block of
    the normed hidden (``plan.act``), replicated on every rank: each
    rank's share of the numerator summed over the ranks that split it
    (``tp.sum_over``: the global view's loss, whose cotangent every rank
    holds whole), over the global count of labelled tokens. The head
    split over `model` (``plan.head == "vocab"``) runs the
    vocab-parallel cross-entropy on the whole sequence; otherwise each
    rank takes its sequence block against the whole vocabulary."""
    from repro_torch.distributed import tp

    cfg = plan.cfg
    labels = torch.as_tensor(labels, device=h.device).long()
    key = "['embed']" if cfg.tie_embeddings else "['lm_head']"
    head = plan.gather_leaf(params["embed" if cfg.tie_embeddings
                                   else "lm_head"], plan.gathers[key])
    if cfg.tie_embeddings:
        head = head.T
    if plan.head == "vocab":
        mg = plan.model_group
        v0 = torch.distributed.get_rank(mg) * head.shape[1]
        tot, cnt = _xent_sums(tp.gather(h, 1, mg), head, labels,
                              chunk=chunk, v0=v0, group=mg)
        group = plan.batch_group
    else:
        tot, cnt = _xent_sums(h, head, plan.seq_block(labels), chunk=chunk)
        group = plan.loss_group
    tot = tp.sum_over(tot, group)
    cnt = tp.all_sum(cnt, group)
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, batch, cfg: TransformerConfig, *, remat=True,
            q_chunk=512, k_chunk=1024, xent_chunk=256, layer_mode="scan",
            act_constraint=None, moe_shardings=None,
            compute_dtype=torch.bfloat16, plan=None):
    """The mean token xent. With an ``act_constraint``: the sharded loss
    over this rank's parameter and batch blocks (``transformer.forward``;
    ``plan`` its ``LMPlan`` where the caller built it), the global
    batch's loss on every rank."""
    if plan is None and act_constraint is not None:
        from repro_torch.distributed.tp import LMPlan
        plan = LMPlan(cfg, act_constraint.mesh, moe_shardings)
    h = tfm.forward(params, batch["tokens"], cfg, remat=remat,
                    q_chunk=q_chunk, k_chunk=k_chunk, layer_mode=layer_mode,
                    compute_dtype=compute_dtype,
                    act_constraint=act_constraint,
                    moe_shardings=moe_shardings, plan=plan)
    if plan is not None:
        return _sharded_xent(h, params, batch["labels"], plan, xent_chunk)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return chunked_cross_entropy(h, head, batch["labels"], chunk=xent_chunk)


def make_lm_value_and_grad(cfg: TransformerConfig, *, remat=True,
                           q_chunk=512, k_chunk=1024, xent_chunk=256,
                           layer_mode="scan", act_constraint=None,
                           moe_shardings=None, compute_dtype=torch.bfloat16):
    """``fn(params, batch) -> (loss, grads)``: the LM loss and its
    gradient. With an ``act_constraint`` (``tp.residual_spec`` over a
    mesh): over this rank's blocks under the config's ``parallelism``
    (``params`` from ``sharding.shard_tree`` with ``lm_param_specs``,
    the batch split over the data axes under "tp_fsdp" and over every
    axis under "fsdp"), the loss the global batch's and each gradient
    leaf this rank's block of the global gradient: summed over the axes
    its computation was split over (``LMPlan.reduce_grads``; a leaf
    sharded over ``fs`` was summed by its gather's reduce-scatter).
    ``fn.plan`` is the ``LMPlan``, built once here (None without a
    constraint)."""
    plan = None
    if act_constraint is not None:
        from repro_torch.distributed.tp import LMPlan
        plan = LMPlan(cfg, act_constraint.mesh, moe_shardings)
    loss_fn = functools.partial(lm_loss, cfg=cfg, remat=remat,
                                q_chunk=q_chunk, k_chunk=k_chunk,
                                xent_chunk=xent_chunk, layer_mode=layer_mode,
                                act_constraint=act_constraint,
                                moe_shardings=moe_shardings,
                                compute_dtype=compute_dtype, plan=plan)

    def fn(params, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        return loss, (grads if plan is None else plan.reduce_grads(grads))
    fn.plan = plan
    return fn


def make_lm_train_step(cfg: TransformerConfig, optimizer, *, remat=True,
                       q_chunk=512, k_chunk=1024, xent_chunk=256,
                       compress=None, layer_mode="scan",
                       act_constraint=None, moe_shardings=None,
                       compute_dtype=torch.bfloat16):
    """The LM train step; with an ``act_constraint``, over this rank's
    blocks (``make_lm_value_and_grad``), the clipping norm counting
    every distinct block once (``LMPlan.norm_reduce``)."""
    grad_fn = make_lm_value_and_grad(
        cfg, remat=remat, q_chunk=q_chunk, k_chunk=k_chunk,
        xent_chunk=xent_chunk, layer_mode=layer_mode,
        act_constraint=act_constraint, moe_shardings=moe_shardings,
        compute_dtype=compute_dtype)
    plan = grad_fn.plan

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        if compress is not None:
            grads = compress(grads)
        kw = {} if plan is None else {"norm_reduce": plan.norm_reduce(grads)}
        params, opt_state = optimizer.update(grads, opt_state, params, **kw)
        return params, opt_state, {"loss": loss}
    return train_step


def make_lm_prefill_step(cfg: TransformerConfig, *, max_len,
                         q_chunk=512, k_chunk=1024, layer_mode="scan",
                         moe_shardings=None, plan=None):
    """``prefill_step(params, tokens) -> (last-position logits, cache)``.
    ``plan``: a serving ``LMPlan``; the step then runs on this rank's
    blocks (``transformer.prefill``), its MoE mode the plan's."""
    @torch.no_grad()
    def prefill_step(params, tokens):
        h, cache = tfm.prefill(params, tokens, cfg, max_len=max_len,
                               q_chunk=q_chunk, k_chunk=k_chunk,
                               layer_mode=layer_mode,
                               moe_shardings=moe_shardings, plan=plan)
        logits = tfm.logits_fn(params, h[:, -1:], cfg, plan)
        return logits, cache
    return prefill_step


def make_lm_decode_step(cfg: TransformerConfig, *, k_chunk=2048,
                        layer_mode="scan", moe_shardings=None, plan=None):
    """``serve_step(params, cache, tokens) -> (logits, new cache)``;
    consumes ``cache`` (see ``transformer.decode_step``). ``plan``: as
    ``make_lm_prefill_step``'s."""
    def serve_step(params, cache, tokens):
        return tfm.decode_step(params, cache, tokens, cfg, k_chunk=k_chunk,
                               layer_mode=layer_mode,
                               moe_shardings=moe_shardings, plan=plan)
    return serve_step


# ------------------------------------------------------------- GNN ---------
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
    raise ValueError(cfg.kind)


def masked_xent(logits, labels, mask=None) -> torch.Tensor:
    """Mean cross-entropy over the nodes of ``mask`` (all without one):
    ``sum((logsumexp - logit[label]) * mask) / max(sum(mask), 1)``.
    The label's logit is picked with a one-hot product, so the backward
    scatters nothing."""
    num, count = _xent_terms(logits, labels, mask)
    return num / torch.clamp(count, min=1.0)


def _xent_terms(logits, labels, mask=None) -> tuple:
    """``masked_xent``'s numerator and mask count."""
    logits = logits.to(torch.float32)
    labels = torch.as_tensor(labels, device=logits.device).long()
    mask = (torch.ones(labels.shape[0], device=logits.device)
            if mask is None
            else torch.as_tensor(mask, device=logits.device)
            ).to(torch.float32)
    lz = torch.logsumexp(logits, dim=-1)
    onehot = one_hot(torch.clamp(labels, min=0), logits.shape[-1])
    tgt = (logits * onehot.to(logits.dtype)).sum(-1)
    return torch.sum((lz - tgt) * mask), mask.sum()


def gnn_node_loss(params, batch, cfg: GNNConfig, constrain=None,
                  gops=None, remat=False):
    """Masked node-classification xent (padding-safe). With the halo ops
    of a mesh (``gops.group``) the batch is this rank's shard of the
    graph and the loss is this rank's share of the global one: its
    numerator over the mask count of every rank."""
    graph = gnn_m.Graph(batch["senders"], batch["receivers"],
                        batch["node_feat"], batch.get("edge_feat"))
    logits = gnn_apply(params, graph, cfg, constrain=constrain, gops=gops,
                       remat=remat)
    group = getattr(gops, "group", None)
    if group is None:
        return masked_xent(logits, batch["labels"], batch.get("node_mask"))
    num, count = _xent_terms(logits, batch["labels"], batch.get("node_mask"))
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    return num / torch.clamp(count, min=1.0)


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


def _sum_over(group, loss, grads) -> tuple:
    """(loss, grads) each summed over ``group``: one all-reduce of one
    flat buffer (every rank holds the same bits after it)."""
    leaves = [loss.reshape(1)] + tree_leaves(grads)
    if len({x.dtype for x in leaves}) != 1:
        raise TypeError("the sharded step sums one dtype; got "
                        f"{sorted({str(x.dtype) for x in leaves})}")
    flat = torch.cat([x.reshape(-1) for x in leaves])
    dist.all_reduce(flat, group=group)
    parts = [p.reshape(x.shape) for p, x in
             zip(torch.split(flat, [x.numel() for x in leaves]), leaves)]
    return parts[0].reshape(()), tree_unflatten(grads, parts[1:])


def _train_step(loss_fn, optimizer, compress=None, group=None):
    """``group``: the ranks whose shares of the loss and gradients are
    summed (before ``compress``, as the reference's global-view step
    compresses the whole gradient); None runs on one rank."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        if group is not None:
            loss, grads = _sum_over(group, loss, grads)
        if compress is not None:
            grads = compress(grads)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}
    return train_step


def _molecules(batch, n_mols: int):
    return dimenet_m.MoleculeBatch(
        **{k: batch[k] for k in dimenet_m.MoleculeBatch._fields
           if k != "n_mols"}, n_mols=n_mols)


def _atom_graph(batch, n_mols: int):
    return nequip_m.AtomGraph(
        **{k: batch[k] for k in nequip_m.AtomGraph._fields
           if k != "n_mols"}, n_mols=n_mols)


def _n_mols(batch, gops) -> int:
    """The molecules of the batch: ``batch["energy"]``'s length, times
    the ranks of the halo group, where ``batch["energy"]`` is this rank's
    block of them (``graph_batch_specs``)."""
    group = getattr(gops, "group", None)
    n = batch["energy"].shape[0]
    return n if group is None else n * dist.get_world_size(group)


def _energy_mse(e, target, gops):
    """The mean squared error of the energies ``e`` [n_mols] against
    ``target``. Under the halo ops ``e`` is every molecule's (summed over
    the group by the model) and ``target`` this rank's block: the rank's
    share is the error of its block, so the shares sum to the loss."""
    group = getattr(gops, "group", None)
    if group is None:
        return torch.mean(torch.square(e - target))
    n = target.shape[0]
    me = dist.get_rank(group)
    own = e[me * n:(me + 1) * n]
    return torch.mean(torch.square(own - target)) * (n / e.shape[0])


def energy_loss_dimenet(params, batch, cfg: GNNConfig, constrain=None,
                        gops=None, remat=False):
    """Mean squared error of DimeNet's per-molecule energies against
    ``batch["energy"]``, whose length is the number of molecules (under
    the halo ops: this rank's block of them, and the loss this rank's
    share)."""
    e = dimenet_m.dimenet_forward(
        params, _molecules(batch, _n_mols(batch, gops)), cfg,
        constrain=constrain, gops=gops, remat=remat)
    return _energy_mse(e, batch["energy"], gops)


def energy_loss_nequip(params, batch, cfg: GNNConfig, constrain=None,
                       gops=None, remat=False):
    """As ``energy_loss_dimenet``, for NequIP."""
    e = nequip_m.nequip_forward(
        params, _atom_graph(batch, _n_mols(batch, gops)), cfg,
        constrain=constrain, gops=gops, remat=remat)
    return _energy_mse(e, batch["energy"], gops)


def make_gnn_train_step(cfg: GNNConfig, optimizer, compress=None,
                        constrain=None, gops=None, remat=False):
    """The GNN train step. With ``gops = make_halo_ops(mesh, axes)`` it
    runs on every rank of the mesh over that rank's shard of a full
    graph (``graph_batch_specs``) and computes what the reference's
    global-view program computes: the loss over every rank's nodes (or
    molecules), and each replicated parameter's gradient summed over
    the ranks before ``compress`` and the optimizer, so every rank takes
    the same step. DimeNet and NequIP sum each molecule's partial
    energy over the ranks before the loss."""
    group = getattr(gops, "group", None)
    loss = {"dimenet": energy_loss_dimenet,
            "nequip": energy_loss_nequip}.get(cfg.kind, gnn_node_loss)
    loss_fn = functools.partial(loss, cfg=cfg, constrain=constrain,
                                gops=gops, remat=remat)
    return _train_step(loss_fn, optimizer, compress, group)


def make_gnn_minibatch_step(cfg: GNNConfig, optimizer, n_total: int,
                            group=None):
    """The sampled-subgraph train step: ``batch`` leaves carry a leading
    subgraph dimension; the loss is the mean of the per-subgraph losses
    over ``n_total`` subgraphs, then one optimizer update (the
    reference's ``vmap``, here a loop). ``group``: the ranks that hold
    the other subgraphs (the batch's data axes), over which each rank's
    share of the loss and its gradients are summed; None when ``batch``
    holds all ``n_total``."""
    loss = {"dimenet": energy_loss_dimenet,
            "nequip": energy_loss_nequip}.get(cfg.kind, gnn_node_loss)

    def loss_fn(params, batch):
        n = next(iter(batch.values())).shape[0]
        losses = [loss(params, {k: v[i] for k, v in batch.items()}, cfg)
                  for i in range(n)]
        return torch.stack(losses).sum() / n_total
    return _train_step(loss_fn, optimizer, group=group)


def make_gnn_serve_step(cfg: GNNConfig, n_mols: int = 1):
    """``serve_step(params, batch)``: node outputs, or for DimeNet and
    NequIP the energies of ``n_mols`` molecules."""
    @torch.no_grad()
    def serve_step(params, batch):
        if cfg.kind == "dimenet":
            return dimenet_m.dimenet_forward(params,
                                             _molecules(batch, n_mols), cfg)
        if cfg.kind == "nequip":
            return nequip_m.nequip_forward(params,
                                           _atom_graph(batch, n_mols), cfg)
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


# ---------------------------------------------------------- recsys ---------
def make_fm_train_step(cfg: RecsysConfig, optimizer, compress=None,
                       shards=None):
    """The FM train step; with ``shards`` (``distributed.rows.FMShards``)
    over a rank's blocks of the tables and of the batch: its share of
    the loss, the loss and the gradients ``shards.summed`` names summed
    over the data axes before ``compress`` and the optimizer."""
    if shards is None:
        def loss_fn(params, batch):
            return fm_m.fm_loss(params, batch["idx"], batch["labels"], cfg)
        return _train_step(loss_fn, optimizer, compress)

    def sharded_loss(params, batch):
        return fm_m.fm_loss(params, batch["idx"], batch["labels"], cfg,
                            lookup=shards.batch,
                            n_total=shards.global_batch(batch["labels"]))

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(sharded_loss, params, batch)
        if shards.data_group is not None:
            loss, summed = _sum_over(shards.data_group, loss,
                                     shards.summed(grads))
            grads = {**grads, **summed}
        if compress is not None:
            grads = compress(grads)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}
    return train_step


def make_fm_serve_step(cfg: RecsysConfig, shards=None):
    """Scores of ``batch["idx"]``; with ``shards``, of this rank's block
    of the batch over its blocks of the tables."""
    lookup = take if shards is None else shards.batch

    @torch.no_grad()
    def serve_step(params, batch):
        return fm_m.fm_score(params, batch["idx"], cfg, lookup)
    return serve_step


def make_fm_retrieval_step(cfg: RecsysConfig, n_user_fields: int,
                           shards=None):
    """One user's context against candidates; with ``shards``, this
    rank's block of the candidates (the context whole on every rank)."""
    user = take if shards is None else shards.context
    cand = take if shards is None else shards.candidates

    @torch.no_grad()
    def serve_step(params, user_idx, cand_idx):
        return fm_m.retrieval_score(params, user_idx, cand_idx, cfg,
                                    n_user_fields, user, cand)
    return serve_step
