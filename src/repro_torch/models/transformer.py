"""Decoder-only transformer family (dense + MoE) in functional PyTorch
(port of ``repro.models.transformer``).

Covers all five LM architectures of the configs: GQA, qk-norm (qwen3),
sliding-window attention (mixtral), MoE top-k routing with
capacity-based gather dispatch (mixtral 8e top-2, qwen3-moe 128e
top-8), RoPE, SwiGLU, RMSNorm, a loop over stacked layers with optional
remat, KV-cache prefill/decode with a ring buffer for SWA.

Parameters are the reference's tree: a dict with stacked ``[L, ...]``
layer leaves under ``"layers"``, so ``convert.tree_from_numpy`` and the
checkpoint keys carry over. The stack is cast once and unbound once per
call (autograd then builds one stacked gradient per leaf). The
reference's layer scan and its unrolled loop are both a Python loop
here (``layer_mode`` "scan" and "unroll" give the same result).

Every gather and sum that has a gradient is deterministic: the embedding
lookup and the MoE dispatch gather go through ``models.common.take``,
the MoE combine through ``models.common.segment_sum`` (a host-built
plan, so one host sync per MoE layer on the card).

Sharding. ``forward(..., act_constraint=...)`` runs the training
forward over the constraint's (data, model) mesh under the config's
``parallelism`` (``distributed.tp.LMPlan``):
``params`` hold this rank's blocks under ``sharding.lm_param_specs``
and ``tokens`` this rank's batch block. Under "tp_fsdp" each layer
gathers its weights over the data axes (ZeRO-3, inside the remat region,
so the recompute gathers again), runs wq/wk/wv/w_gate/w_up as
column-parallel and wo/w_down as row-parallel products over `model`,
and keeps the residual stream sequence-split over `model` between
layers (the reference's ``act_constraint`` ``P(dp, model, None)``);
where a rank's column block is not whole heads the projections are
gathered over `model` before attention. Under "fsdp" every weight is
gathered over every axis and the batch is split over every axis. The
reference gets these collectives from GSPMD; here they are
``distributed.tp``'s, and ``_constrain`` is a real layout change
(``sharding.with_sharding_constraint``).

MoE under a mesh: an ``"ep_mesh"`` dict in ``moe_shardings`` (what
``make_moe_shardings`` gives an expert-parallel mesh) routes each MoE
layer to ``models.moe_ep.moe_ffn_ep``: this rank's tokens, this rank's
slice of the experts. The tensor-parallel dict (``"xs"``, ``"h"``,
``"flat"``, ``"tokens"``, as ``sharding.tp_expert_shardings`` makes it)
runs ``moe_ffn`` with d_ff split over `model` and the capacity ranks
taken over the global batch (the tokens the unsharded layer drops are
the ones dropped); each data rank dispatches its own tokens.

Sharded serving. ``prefill`` and ``decode_step`` given ``plan=`` (an
``LMPlan``; the reference's serving cells build it under "tp_fsdp"
whatever the config's ``parallelism``, ``launch.specs.build_lm_cell``)
run on this rank's blocks: the parameters under ``lm_param_specs``,
the tokens and the KV cache split over the plan's batch axes and whole
over `model` (``plan.cache``, the reference's ``lm_cache_specs``). Each
layer gathers its weights over the data axes, runs the column- and
row-parallel products over `model` with the residual stream whole on
every model rank (a row-parallel output is all-reduced, decode has one
position), and in ``"heads"`` mode all-gathers this rank's k and v
heads over `model` before the cache write; each rank's query heads
attend to its own kv heads of the cache. MoE layers run as in the
training forward: ``moe_ffn_ep``, or ``moe_ffn`` with capacity ranked
over the global batch (a batch that does not divide over the data axes
is whole on every rank and ranks its own tokens). The logits are whole
over `model` (the vocabulary all-gathered where the head is split).
Without a plan the passes run on whole tensors: they take the
tensor-parallel dict over one rank, where it changes nothing, and
refuse it over more (``plan=`` is then needed), as ``forward`` without
an ``act_constraint`` does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map

from .attention import chunked_attention
from .common import (apply_rope, normal_init, one_hot, rms_norm, segment_sum,
                     take)

NEG_INF = -1e30
LAYER_MODES = ("scan", "unroll")


def _constrain(x, sharding, src=None):
    """``jax.lax.with_sharding_constraint``: ``x`` (this rank's block
    under the spec ``src``, the whole tensor by default) as its block
    under ``sharding``; None: no constraint."""
    if sharding is None:
        return x
    from repro_torch.distributed.sharding import with_sharding_constraint
    return with_sharding_constraint(x, sharding, src)


# ------------------------------------------------------------ params -------
def _layer_shapes(cfg: TransformerConfig) -> dict:
    """key -> (shape, init): "ones", or a N(0, 0.02²) draw."""
    d, dh = cfg.d_model, cfg.d_head
    h, kv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    p = {"attn_norm": ((d,), "ones"), "ffn_norm": ((d,), "ones"),
         "wq": ((d, h * dh), "normal"), "wk": ((d, kv * dh), "normal"),
         "wv": ((d, kv * dh), "normal"), "wo": ((h * dh, d), "normal")}
    if cfg.qk_norm:
        p["q_norm"] = ((dh,), "ones")
        p["k_norm"] = ((dh,), "ones")
    if cfg.moe:
        e = cfg.n_experts
        p["router"] = ((d, e), "normal")
        p["w_gate"] = ((e, d, f), "normal")
        p["w_up"] = ((e, d, f), "normal")
        p["w_down"] = ((e, f, d), "normal")
    else:
        p["w_gate"] = ((d, f), "normal")
        p["w_up"] = ((d, f), "normal")
        p["w_down"] = ((f, d), "normal")
    return p


def _draw(gen: torch.Generator, cfg, lead: tuple = ()) -> dict:
    return {k: (torch.ones(lead + shape, device=gen.device)
                if init == "ones" else normal_init(gen, lead + shape))
            for k, (shape, init) in _layer_shapes(cfg).items()}


def init_layer_params(cfg: TransformerConfig, gen: torch.Generator):
    """One layer's parameters, drawn from ``gen`` on its device."""
    return _draw(gen, cfg)


def init_params(cfg: TransformerConfig, gen: torch.Generator,
                device="cuda"):
    """The model's parameters drawn from ``gen`` on its device (each
    layer leaf drawn stacked, [L, ...]), placed on ``device``."""
    dev = resolve_device(device)
    params = {
        "embed": normal_init(gen, (cfg.vocab, cfg.d_model)),
        "layers": _draw(gen, cfg, (cfg.n_layers,)),
        "final_norm": torch.ones((cfg.d_model,), device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, cfg.vocab))
    return tree_map(lambda p: p.to(dev), params)


# -------------------------------------------------------------- MoE --------
def moe_route(x, router, k: int):
    """The router's top-k: (weights renormalized over the k, expert ids),
    both [T, k], from an f32 softmax over the experts."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                   # [T, E]
    topv, topi = torch.topk(probs, k, dim=-1)               # [T, k]
    return topv / topv.sum(dim=-1, keepdim=True), topi


def _ranks(e_flat, e_first: int, e_local: int):
    """(one-hot [T*k, e_local + 1] of each assignment's expert among
    ``[e_first, e_first + e_local)``, the last column for any other
    expert; each assignment's rank: the count of earlier ones to its
    expert)."""
    local_e = e_flat - e_first
    mine = (local_e >= 0) & (local_e < e_local)
    onehot = one_hot(torch.where(mine, local_e,
                                 torch.full_like(local_e, e_local)),
                     e_local + 1)                           # [T*k, E+1]
    rank = torch.cumsum(onehot, dim=0) - 1                  # rank in expert
    return onehot, torch.sum(rank * onehot, dim=-1)         # [T*k]


def _slot_dest(e_flat, c: int, e_first: int, e_local: int):
    """Each assignment's slot among experts ``[e_first, e_first +
    e_local)`` (``e_local * c``: the dump slot). An assignment's rank is
    the count of earlier ones to its expert; those at rank >= c, and
    those to other experts, go to the dump slot."""
    local_e = e_flat - e_first
    mine = (local_e >= 0) & (local_e < e_local)
    _, rank = _ranks(e_flat, e_first, e_local)
    keep = mine & (rank < c)
    return torch.where(keep, local_e * c + rank,
                       torch.full_like(rank, e_local * c))  # dump slot


def _window_dest(e_flat, c: int, w: int, e: int, dg=None):
    """Each of this rank's assignments' slot in windows of ``w`` slots an
    expert (``e * w``: the dump slot), for a capacity of ``c`` ranked
    over the assignments of every rank of the data group ``dg`` in rank
    order (None: this rank's only). An assignment's global rank is its
    rank here plus the assignments to its expert on the data ranks
    before this one (one all-gather of the counts); those at global rank
    >= c are dropped, a kept one takes the slot of its rank here. A
    token's k experts are distinct, so that rank is below the token
    count, and ``w = min(c, T)`` slots hold every kept one."""
    from repro_torch.distributed import tp

    onehot, rank = _ranks(e_flat, 0, e)
    room = torch.full((e + 1,), c, dtype=rank.dtype, device=rank.device)
    room[e] = 0                                             # no expert
    if dg is not None:
        counts = tp._all_gather(onehot[None, :, :e].sum(dim=1), 0, dg)
        before = counts[:torch.distributed.get_rank(dg)].sum(dim=0)  # [E]
        room[:e] = (c - before).clamp(min=0)
    keep = rank < torch.sum(onehot * room, dim=-1)
    return torch.where(keep, e_flat * w + rank,
                       torch.full_like(rank, e * w))        # dump slot


def moe_slots(topv, topi, c: int, e_first: int, e_local: int, dest=None):
    """The dispatch of top-k assignments onto the capacity slots of
    experts ``[e_first, e_first + e_local)``:
    (``slot_tok`` [e_local * c] token per slot, ``slot_w`` [e_local, c]
    its weight). An assignment's rank is the count of earlier ones to
    its expert; those at rank >= c, and those to other experts, go to a
    dump slot that is discarded. An empty slot holds token 0 with weight
    0, as in the reference. ``dest``: each assignment's slot, where the
    caller ranked them (``_slot_dest``)."""
    t, k = topi.shape
    dev = topi.device
    e_flat = topi.reshape(-1)                               # [T*k]
    w_flat = topv.reshape(-1)
    tok_flat = torch.arange(t, device=dev).repeat_interleave(k)
    if dest is None:
        dest = _slot_dest(e_flat, c, e_first, e_local)

    # duplicates are written only into the dump slot, which is discarded
    n = e_local * c
    slot_tok = torch.zeros((n + 1,), dtype=torch.long,
                           device=dev).index_put((dest,), tok_flat)
    slot_w = torch.zeros((n + 1,), dtype=torch.float32,
                         device=dev).index_put((dest,), w_flat)
    return slot_tok[:n], slot_w[:n].reshape(e_local, c)


def moe_experts(x, p, slot_tok, slot_w, tp_group=None):
    """The SwiGLU experts of ``p`` (``w_*`` [e, ...]) over their slots,
    each output weighted and summed onto its token in slot order (the
    plan ``segment_sum``) -> [T, D] in ``x``'s dtype. ``tp_group``: the
    experts' d_ff is split over it (``x`` replicated over it; the
    column-parallel input and the row-parallel output's sum, the
    Megatron pair)."""
    from repro_torch.distributed import tp

    t, d = x.shape
    e, c = slot_w.shape
    xin = x if tp_group is None else tp.copy_to(x, tp_group)
    xs = take(xin, slot_tok).reshape(e, c, d)
    h = F.silu(torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
    y = torch.bmm(h, p["w_down"])                           # [E, C, D]
    if tp_group is not None:
        y = tp.sum_over(y, tp_group)

    # combine in the compute dtype, as the reference
    y = (y * slot_w[..., None].to(y.dtype)).reshape(e * c, d)
    out = segment_sum(y, slot_tok, t)
    return out.to(x.dtype)


def _tp_experts(shardings, cfg, f_local: int) -> tuple:
    """(data group, number of data ranks, model group or None) of the
    tensor-parallel dict: the tokens' data axes (``"tokens"``), and the
    model axis (``"h"``'s last entry) where the experts' d_ff is split
    over it."""
    from repro_torch.launch.mesh import axes_group, axes_size

    mesh = shardings["tokens"].mesh
    dp = shardings["tokens"].spec[0]
    mdl = shardings["h"].spec[2] if len(shardings["h"].spec) > 2 else None
    n_mdl = axes_size(mesh, mdl)
    if mdl is not None and f_local * n_mdl == cfg.d_ff:
        mg = axes_group(mesh, mdl)             # a block (over one rank: all)
    elif f_local == cfg.d_ff:
        mg = None                              # the same experts everywhere
    else:
        raise ValueError(f"experts hold {f_local} of d_ff {cfg.d_ff}; over "
                         f"{n_mdl} model ranks that is neither all nor a "
                         "block")
    dg = axes_group(mesh, dp) if dp is not None else None
    return dg, axes_size(mesh, dp), mg


def moe_ffn(x, p, cfg: TransformerConfig, capacity: Optional[int] = None,
            shardings=None):
    """Capacity-based top-k MoE with gather dispatch (no [T,E,C] one-hots).

    x [T, D] flattened tokens -> [T, D]. Assignments past an expert's
    capacity go to a dump slot and are dropped; an empty slot gathers
    token 0 with weight 0, as in the reference.

    ``shardings``: the tensor-parallel dict (``"xs"``, ``"h"``,
    ``"flat"``, ``"tokens"``). ``x`` is then this rank's block of the
    tokens (over the data axes of ``"tokens"``, replicated over
    `model`), and the expert stacks hold this rank's d_ff block where
    d_ff is split over `model` (``"h"``). The expert ids of every data
    rank are gathered and ranked together, so capacity and drops are
    the global batch's (the reference's global view, capacity from the
    global token count); each rank holds and computes only the slots of
    its own tokens, a window of ``min(c, T)`` an expert
    (``_window_dest``), and sums ``[E, min(c, T), D]`` over `model`.
    """
    from repro_torch.distributed import tp

    t, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    topv, topi = moe_route(x, p["router"], k)
    if not tp.is_tp_expert_dict(shardings):
        if capacity is None:
            capacity = int(np.ceil(t * k / e * cfg.capacity_factor))
        slot_tok, slot_w = moe_slots(topv, topi, max(capacity, 1), 0, e)
        return moe_experts(x, p, slot_tok, slot_w)
    dg, n_dp, mg = _tp_experts(shardings, cfg, p["w_gate"].shape[-1])
    if capacity is None:
        capacity = int(np.ceil(t * n_dp * k / e * cfg.capacity_factor))
    c = max(capacity, 1)
    w = min(c, t)
    dest = _window_dest(topi.reshape(-1), c, w, e, dg)
    slot_tok, slot_w = moe_slots(topv, topi, w, 0, e, dest=dest)
    return moe_experts(x, p, slot_tok, slot_w, tp_group=mg)


def dense_ffn(x, p):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def _cast_layer(lp, dtype):
    """Every float32 leaf in ``dtype`` (the norm scales too, as the
    reference's code does); None keeps the leaves as they are."""
    if dtype is None:
        return lp
    return tree_map(
        lambda x: x.to(dtype) if x.dtype == torch.float32 else x, lp)


def _ffn(h, lp, cfg, moe_shardings=None):
    b, s, d = h.shape
    hn = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    if cfg.moe:
        if isinstance(moe_shardings, dict) and "ep_mesh" in moe_shardings:
            from .moe_ep import moe_ffn_ep
            out = moe_ffn_ep(hn.reshape(b * s, d), lp, cfg,
                             moe_shardings["ep_mesh"],
                             dp_axes=moe_shardings["dp"],
                             mdl_axis=moe_shardings["mdl"])
            return out.reshape(b, s, d)
        return moe_ffn(hn.reshape(b * s, d), lp, cfg).reshape(b, s, d)
    return dense_ffn(hn, lp)


def _whole_tensor_moe(moe_shardings, where: str):
    """``moe_shardings`` for a pass over whole tensors (the mesh-less
    forward, prefill and decode without a plan): the "ep_mesh" dict as
    it is; the tensor-parallel dict over one rank changes nothing
    (None); over more ranks it needs this rank's block of the tokens,
    which only the sharded passes hold."""
    from repro_torch.distributed import tp
    from repro_torch.launch.mesh import mesh_shape

    if not tp.is_tp_expert_dict(moe_shardings):
        return moe_shardings
    n = int(np.prod(list(mesh_shape(moe_shardings["tokens"].mesh)
                         .values())))
    if n == 1:
        return None
    if where == "forward":
        raise NotImplementedError(
            f"forward: the tensor-parallel MoE dict over {n} ranks runs in "
            "the sharded training forward only (an act_constraint)")
    raise ValueError(f"{where}: the tensor-parallel MoE dict over {n} "
                     "ranks needs this rank's blocks: pass plan= (an "
                     "LMPlan over its mesh)")


def _project_qkv(hn, lp, cfg, q_pos, heads=None, proj=None):
    """q, k, v [B, S, heads, Dh] after qk-norm and RoPE. ``heads``: the
    (query, kv) head counts this rank holds (the config's by default);
    ``proj(name)``: the projection by ``lp[name]`` (``hn @ lp[name]`` by
    default)."""
    b, s, _ = hn.shape
    nh, nkv = heads or (cfg.n_heads, cfg.n_kv_heads)
    proj = proj or (lambda name: hn @ lp[name])
    q = proj("wq").reshape(b, s, nh, cfg.d_head)
    kk = proj("wk").reshape(b, s, nkv, cfg.d_head)
    vv = proj("wv").reshape(b, s, nkv, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        kk = rms_norm(kk, lp["k_norm"], cfg.norm_eps)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    kk = apply_rope(kk, q_pos, cfg.rope_theta)
    return q, kk, vv


# ----------------------------------------------------------- forward -------
def _layers(params, cfg, compute_dtype, layer_mode) -> list:
    """Per-layer parameter dicts: the stack cast once, unbound once."""
    if layer_mode not in LAYER_MODES:
        raise ValueError(f"layer_mode must be one of {LAYER_MODES}, got "
                         f"{layer_mode!r}")
    stacked = _cast_layer(params["layers"], compute_dtype)
    cols = {k: torch.unbind(v) for k, v in stacked.items()}
    return [{k: cols[k][i] for k in cols} for i in range(cfg.n_layers)]


def _embed(params, tokens, compute_dtype):
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    return tokens, take(params["embed"], tokens).to(
        compute_dtype or torch.float32)


def forward(params, tokens, cfg: TransformerConfig, *, remat: bool = True,
            q_chunk: int = 512, k_chunk: int = 1024,
            layer_mode: str = "scan", compute_dtype=torch.bfloat16,
            act_constraint=None, moe_shardings=None, plan=None):
    """Training forward: tokens [B, S] -> normed hidden [B, S, D].

    ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint``.

    With an ``act_constraint``: the sharded forward on this rank's
    blocks over its mesh, under the config's ``parallelism`` (module
    docstring); the result is this rank's block of the normed hidden in
    the residual layout (``tp.residual_spec``: [B/|dp|, S/|model|, D]
    under "tp_fsdp"). ``plan``: the ``LMPlan`` of that constraint, where
    the caller has built it (``train.steps.make_lm_value_and_grad``).
    """
    if plan is None and act_constraint is not None:
        from repro_torch.distributed.tp import LMPlan
        plan = LMPlan(cfg, act_constraint.mesh, moe_shardings)
    if plan is not None:
        return _forward_sharded(params, tokens, cfg, plan, remat=remat,
                                q_chunk=q_chunk, k_chunk=k_chunk,
                                layer_mode=layer_mode,
                                compute_dtype=compute_dtype,
                                act_constraint=act_constraint)
    moe_shardings = _whole_tensor_moe(moe_shardings, "forward")
    tokens, h = _embed(params, tokens, compute_dtype)
    b, s = tokens.shape
    q_pos = torch.arange(s, device=h.device)

    def layer(h, lp):
        hn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, kk, vv = _project_qkv(hn, lp, cfg, q_pos)
        attn = chunked_attention(q, kk, vv, q_pos=q_pos, kv_pos=q_pos,
                                 causal=True, window=cfg.sliding_window,
                                 q_chunk=q_chunk, k_chunk=k_chunk)
        h = h + attn.reshape(b, s, -1) @ lp["wo"]
        return h + _ffn(h, lp, cfg, moe_shardings)

    for lp in _layers(params, cfg, compute_dtype, layer_mode):
        h = (checkpoint(layer, h, lp, use_reentrant=False) if remat
             else layer(h, lp))
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def _forward_sharded(params, tokens, cfg, plan, *, remat, q_chunk, k_chunk,
                     layer_mode, compute_dtype, act_constraint):
    from repro_torch.distributed.sharding import same_layout

    if act_constraint is not None and not same_layout(
            act_constraint.spec, plan.act, plan.mesh):
        raise ValueError(f"the {plan.strategy} forward keeps the residual "
                         f"stream in {plan.act}; act_constraint asks for "
                         f"{act_constraint.spec}")
    embed = plan.gather_leaf(params["embed"], plan.gathers["['embed']"])
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    s = tokens.shape[1]
    h = take(embed, plan.seq_block(tokens)).to(compute_dtype or torch.float32)
    del embed
    q_pos = torch.arange(s, device=h.device)
    gathers = plan.layer_gathers()

    def layer(h, lp):
        # ZeRO-3: the weights gathered here, inside the remat region
        lp = {k: plan.gather_leaf(v, gathers[k]) for k, v in lp.items()}
        h = h + _attention_sharded(h, lp, cfg, plan, q_pos, q_chunk, k_chunk)
        return h + _ffn_sharded(h, lp, cfg, plan)

    # the recompute replays the whole layer, every collective included
    with set_checkpoint_early_stop(False):
        for lp in _layers(params, cfg, compute_dtype, layer_mode):
            h = (checkpoint(layer, h, lp, use_reentrant=False) if remat
                 else layer(h, lp))
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def _layouts(plan):
    """(whole, split): the layout changes between the residual block
    (``plan.act``) and this data rank's tokens at every position
    (``plan.tokens``)."""
    from repro_torch.distributed.sharding import NamedSharding

    tokens = NamedSharding(plan.mesh, plan.tokens)
    act = NamedSharding(plan.mesh, plan.act)
    return (lambda x: _constrain(x, tokens, plan.act),
            lambda x: _constrain(x, act, plan.tokens))


def _attention_sharded(h, lp, cfg, plan, q_pos, q_chunk, k_chunk):
    """The attention block's output on this rank's residual block:
    column-parallel q/k/v, row-parallel wo (``plan.attn``)."""
    from repro_torch.distributed import tp

    mg = plan.model_group
    b, s = h.shape[0], q_pos.shape[0]
    hn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)

    def attend(q, kk, vv):
        return chunked_attention(q, kk, vv, q_pos=q_pos, kv_pos=q_pos,
                                 causal=True, window=cfg.sliding_window,
                                 q_chunk=q_chunk, k_chunk=k_chunk)

    if plan.attn == "heads":      # Megatron-SP: this rank's whole heads
        x = tp.gather(hn, 1, mg)
        q, kk, vv = _project_qkv(x, lp, cfg, q_pos, heads=(
            cfg.n_heads // plan.m, cfg.n_kv_heads // plan.m))
        out = attend(q, kk, vv).reshape(b, s, -1) @ lp["wo"]
        return tp.scatter(out, 1, mg)
    # every head on every model rank: split projections gathered
    whole, split = _layouts(plan)
    x = whole(hn)
    xc = tp.copy_to(x, mg) if any(plan.col_split.values()) else x

    def proj(name):
        if plan.col_split[name]:
            return tp.unshard(xc @ lp[name], 2, mg)
        return x @ lp[name]
    attn = attend(*_project_qkv(x, lp, cfg, q_pos, proj=proj))
    attn = attn.reshape(b, s, -1)
    if plan.wo_split:
        return tp.scatter(tp.shard(attn, 2, mg) @ lp["wo"], 1, mg)
    return split(attn @ lp["wo"])


def _ffn_sharded(h, lp, cfg, plan):
    """The FFN block's output on this rank's residual block: d_ff
    column- then row-parallel, or the MoE layer on this data rank's
    tokens."""
    from repro_torch.distributed import tp

    mg = plan.model_group
    b, d = h.shape[0], h.shape[2]
    hn = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    whole, split = _layouts(plan)
    if cfg.moe:
        x = whole(hn)
        s = x.shape[1]
        if plan.moe == "ep":
            from .moe_ep import moe_ffn_ep
            ms = plan.moe_shardings
            out = moe_ffn_ep(x.reshape(b * s, d), lp, cfg, ms["ep_mesh"],
                             dp_axes=ms["dp"], mdl_axis=ms["mdl"])
        else:
            out = moe_ffn(x.reshape(b * s, d), lp, cfg,
                          shardings=plan.moe_shardings)
        return split(out.reshape(b, s, d))
    if plan.ffn == "split":
        return tp.scatter(dense_ffn(tp.gather(hn, 1, mg), lp), 1, mg)
    return split(dense_ffn(whole(hn), lp))


def logits_fn(params, h, cfg: TransformerConfig, plan=None):
    """``h @ head``; with a serving ``plan``: from this rank's block of
    the head, the logits whole over `model`."""
    if plan is None:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return h @ head
    from repro_torch.distributed import tp

    name = "embed" if cfg.tie_embeddings else "lm_head"
    head = plan.gather_leaf(params[name], plan.gathers[f"['{name}']"])
    out = h @ (head.T if cfg.tie_embeddings else head)
    if plan.head == "vocab":
        out = tp.gather(out, out.dim() - 1, plan.model_group)
    return out


class _Serve:
    """The blocks of the serving passes (prefill, decode): over whole
    tensors (``plan`` None), or over this rank's blocks under a serving
    ``LMPlan`` (module docstring). Each block runs the whole-tensor
    operations in their order, a collective where the plan splits
    them, so over one rank both give the same bits."""

    def __init__(self, cfg, plan, moe_shardings, where: str):
        self.cfg, self.plan, self.kv_block = cfg, plan, None
        if plan is None:
            self.moe = _whole_tensor_moe(moe_shardings, where)
            return
        self.mg = plan.model_group
        self.gathers = plan.layer_gathers()
        if plan.attn == "heads" and plan.m > 1:
            n = cfg.n_kv_heads // plan.m
            me = torch.distributed.get_rank(self.mg)
            self.kv_block = slice(me * n, (me + 1) * n)

    def embed(self, params, tokens, compute_dtype):
        if self.plan is None:
            return _embed(params, tokens, compute_dtype)
        embed = self.plan.gather_leaf(params["embed"],
                                      self.plan.gathers["['embed']"])
        tokens = torch.as_tensor(tokens, device=embed.device).long()
        return tokens, take(embed, tokens).to(compute_dtype or torch.float32)

    def layers(self, params, compute_dtype, layer_mode):
        """Each layer's parameters, its weights gathered over the data
        axes as the layer comes (ZeRO-3: one layer whole at a time)."""
        for lp in _layers(params, self.cfg, compute_dtype, layer_mode):
            yield lp if self.plan is None else {
                k: self.plan.gather_leaf(v, self.gathers[k])
                for k, v in lp.items()}

    def qkv(self, hn, lp, q_pos) -> tuple:
        """(q, k, v) of this rank's heads, and (k, v) of every kv head
        (the cache's)."""
        from repro_torch.distributed import tp

        cfg, p = self.cfg, self.plan
        if p is None or p.attn == "replicated":
            q, kk, vv = _project_qkv(hn, lp, cfg, q_pos)
            return q, kk, vv, kk, vv
        if p.attn == "heads":
            q, kk, vv = _project_qkv(hn, lp, cfg, q_pos, heads=(
                cfg.n_heads // p.m, cfg.n_kv_heads // p.m))
            return (q, kk, vv, tp.gather(kk, 2, self.mg),
                    tp.gather(vv, 2, self.mg))

        def proj(name):           # a column block that is not whole heads
            y = hn @ lp[name]
            return tp.gather(y, 2, self.mg) if p.col_split[name] else y
        q, kk, vv = _project_qkv(hn, lp, cfg, q_pos, proj=proj)
        return q, kk, vv, kk, vv

    def own(self, kv):
        """The kv heads of the cache this rank's query heads attend."""
        return kv if self.kv_block is None else kv[:, :, self.kv_block]

    def attn_out(self, attn, lp):
        """The attention block's output, whole over `model` (wo
        row-parallel where it is split)."""
        from repro_torch.distributed import tp

        b, s = attn.shape[:2]
        attn = attn.reshape(b, s, -1)
        p = self.plan
        if p is None or not p.wo_split:
            return attn @ lp["wo"]
        if p.attn != "heads":     # every head here: this rank's rows of wo
            attn = tp.shard(attn, 2, self.mg)
        return tp.sum_over(attn @ lp["wo"], self.mg)

    def ffn(self, h, lp):
        """The FFN block's output, whole over `model`."""
        from repro_torch.distributed import tp

        cfg, p = self.cfg, self.plan
        if p is None:
            return _ffn(h, lp, cfg, self.moe)
        b, s, d = h.shape
        hn = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        if cfg.moe:
            x = hn.reshape(b * s, d)
            if p.moe == "ep":
                from .moe_ep import moe_ffn_ep
                ms = p.moe_shardings
                out = moe_ffn_ep(x, lp, cfg, ms["ep_mesh"], dp_axes=ms["dp"],
                                 mdl_axis=ms["mdl"])
            else:
                out = moe_ffn(x, lp, cfg, shardings=p.moe_shardings)
            return out.reshape(b, s, d)
        if p.ffn == "split":
            return tp.sum_over(dense_ffn(hn, lp), self.mg)
        return dense_ffn(hn, lp)


# --------------------------------------------------------- KV cache --------
def cache_len(cfg: TransformerConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Ring-buffer KV cache. For SWA models the buffer is only
    ``sliding_window`` long — that is the sub-quadratic long-context story."""
    dev = resolve_device(device)
    t = cache_len(cfg, max_len)
    shape = (cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        # absolute position per slot, and the count of tokens so far
        "pos": torch.full((batch, t), -1, dtype=torch.int32, device=dev),
        "index": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def decode_step(params, cache, tokens, cfg: TransformerConfig, *,
                k_chunk: int = 2048, layer_mode: str = "scan",
                compute_dtype=torch.bfloat16, moe_shardings=None, plan=None):
    """One decode step: tokens [B, 1] -> (logits [B, 1, V], new cache).

    Consumes ``cache``: its ``k``, ``v`` and ``pos`` are written in place
    (the new token's slot, ``index % t_buf``) and are the new cache's,
    as the reference's decode reuses a donated cache. ``index`` is a new
    tensor. No host sync but the MoE combine's plan. ``plan``: a serving
    ``LMPlan``; ``params``, ``cache`` and ``tokens`` are then this rank's
    blocks, and so are the logits (whole over `model`) and the cache."""
    run = _Serve(cfg, plan, moe_shardings, "decode_step")
    tokens, h = run.embed(params, tokens, compute_dtype)
    b = tokens.shape[0]
    t_buf = cache["k"].shape[2]
    pos = cache["index"]                       # absolute position of token
    q_pos = pos.reshape(1).to(torch.int32)     # [1]
    slot = torch.remainder(pos, t_buf).reshape(1).long()

    new_pos = cache["pos"]
    new_pos.index_copy_(1, slot, q_pos.expand(b, 1).contiguous())
    kv_valid = new_pos >= 0

    for i, lp in enumerate(run.layers(params, compute_dtype, layer_mode)):
        kc, vc = cache["k"][i], cache["v"][i]
        hn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, _, _, kk, vv = run.qkv(hn, lp, q_pos)
        kc.index_copy_(1, slot, kk.to(kc.dtype))
        vc.index_copy_(1, slot, vv.to(vc.dtype))
        attn = chunked_attention(q, run.own(kc), run.own(vc), q_pos=q_pos,
                                 kv_pos=new_pos, kv_valid=kv_valid,
                                 causal=True, window=cfg.sliding_window,
                                 q_chunk=1, k_chunk=k_chunk)
        h = h + run.attn_out(attn, lp)
        h = h + run.ffn(h, lp)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, h, cfg, plan)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": new_pos,
                 "index": pos + 1}
    return logits, new_cache


@torch.no_grad()
def prefill(params, tokens, cfg: TransformerConfig, *, max_len: int,
            q_chunk: int = 512, k_chunk: int = 1024,
            cache_dtype=torch.bfloat16, layer_mode: str = "scan",
            compute_dtype=torch.bfloat16, moe_shardings=None, plan=None):
    """Prefill the prompt, return (normed hidden [B,S,D], cache).
    ``plan``: a serving ``LMPlan``; ``params`` and ``tokens`` are then
    this rank's blocks, and so are the hidden (whole over `model`) and
    the cache (``plan.cache``)."""
    run = _Serve(cfg, plan, moe_shardings, "prefill")
    tokens, h = run.embed(params, tokens, compute_dtype)
    b, s = tokens.shape
    dev = h.device
    q_pos = torch.arange(s, device=dev)
    t_buf = cache_len(cfg, max_len)
    keep = min(t_buf, s)

    # Ring invariant shared with decode_step: absolute position p lives at
    # slot p % t_buf. The trailing `keep` tokens go to slots 0..keep, then
    # a static roll by (s - keep) % t_buf restores the invariant.
    shift = (s - keep) % t_buf

    shape = (cfg.n_layers, b, t_buf, cfg.n_kv_heads, cfg.d_head)
    k_all = torch.zeros(shape, dtype=cache_dtype, device=dev)
    v_all = torch.zeros(shape, dtype=cache_dtype, device=dev)
    for i, lp in enumerate(run.layers(params, compute_dtype, layer_mode)):
        hn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, kk, vv, k_heads, v_heads = run.qkv(hn, lp, q_pos)
        attn = chunked_attention(q, kk, vv, q_pos=q_pos, kv_pos=q_pos,
                                 causal=True, window=cfg.sliding_window,
                                 q_chunk=q_chunk, k_chunk=k_chunk)
        h = h + run.attn_out(attn, lp)
        k_all[i, :, :keep] = k_heads[:, s - keep:].to(cache_dtype)
        v_all[i, :, :keep] = v_heads[:, s - keep:].to(cache_dtype)
        h = h + run.ffn(h, lp)
    if shift:
        k_all = torch.roll(k_all, shift, dims=2)
        v_all = torch.roll(v_all, shift, dims=2)
    slots = torch.full((t_buf,), -1, dtype=torch.int32, device=dev)
    slots[:keep] = torch.arange(s - keep, s, dtype=torch.int32, device=dev)
    if shift:
        slots = torch.roll(slots, shift)
    pos = slots[None, :].expand(b, t_buf).clone()
    cache = {"k": k_all, "v": v_all, "pos": pos,
             "index": torch.tensor(s, dtype=torch.int32, device=dev)}
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, cache
