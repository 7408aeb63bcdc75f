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

Sharding: an ``"ep_mesh"`` dict in ``moe_shardings`` (what
``make_moe_shardings`` gives an expert-parallel mesh) routes each MoE
layer to ``models.moe_ep.moe_ffn_ep``: this rank's tokens, this rank's
slice of the experts. The GSPMD constraints (``act_constraint``, and the
tensor-parallel ``moe_shardings`` dict of ``NamedSharding``s) change no
value in the reference; here they are checked against the tensor
(``distributed.sharding.with_sharding_constraint``) and leave it as it
is where the constrained axes have one rank. Where an axis has more,
they raise ``NotImplementedError``: tensor-parallel and FSDP execution
of the LM is a later slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map

from .attention import chunked_attention
from .common import apply_rope, normal_init, rms_norm, segment_sum, take

NEG_INF = -1e30
LAYER_MODES = ("scan", "unroll")


def _constrain(x, sharding):
    """``jax.lax.with_sharding_constraint``: ``x`` checked against
    ``sharding`` and returned unchanged (None: no constraint)."""
    if sharding is None:
        return x
    from repro_torch.distributed.sharding import with_sharding_constraint
    return with_sharding_constraint(x, sharding)


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


def moe_slots(topv, topi, c: int, e_first: int, e_local: int):
    """The dispatch of top-k assignments onto the capacity slots of
    experts ``[e_first, e_first + e_local)``:
    (``slot_tok`` [e_local * c] token per slot, ``slot_w`` [e_local, c]
    its weight). An assignment's rank is the count of earlier ones to
    its expert; those at rank >= c, and those to other experts, go to a
    dump slot that is discarded. An empty slot holds token 0 with weight
    0, as in the reference."""
    t, k = topi.shape
    dev = topi.device
    e_flat = topi.reshape(-1)                               # [T*k]
    w_flat = topv.reshape(-1)
    tok_flat = torch.arange(t, device=dev).repeat_interleave(k)
    local_e = e_flat - e_first
    mine = (local_e >= 0) & (local_e < e_local)

    onehot = F.one_hot(torch.where(mine, local_e,
                                   torch.full_like(local_e, e_local)),
                       e_local + 1)                         # [T*k, E+1]
    rank = torch.cumsum(onehot, dim=0) - 1                  # rank in expert
    rank = torch.sum(rank * onehot, dim=-1)                 # [T*k]
    keep = mine & (rank < c)
    dest = torch.where(keep, local_e * c + rank,
                       torch.full_like(rank, e_local * c))  # dump slot

    # duplicates are written only into the dump slot, which is discarded
    n = e_local * c
    slot_tok = torch.zeros((n + 1,), dtype=torch.long,
                           device=dev).index_put((dest,), tok_flat)
    slot_w = torch.zeros((n + 1,), dtype=torch.float32,
                         device=dev).index_put((dest,), w_flat)
    return slot_tok[:n], slot_w[:n].reshape(e_local, c)


def moe_experts(x, p, slot_tok, slot_w, shardings=None):
    """The SwiGLU experts of ``p`` (``w_*`` [e, ...]) over their slots,
    each output weighted and summed onto its token in slot order (the
    plan ``segment_sum``) -> [T, D] in ``x``'s dtype."""
    t, d = x.shape
    e, c = slot_w.shape
    cons = shardings or {}
    xs = _constrain(take(x, slot_tok).reshape(e, c, d), cons.get("xs"))
    h = F.silu(torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
    h = _constrain(h, cons.get("h"))
    y = _constrain(torch.bmm(h, p["w_down"]), cons.get("xs"))  # [E, C, D]

    # combine in the compute dtype, as the reference
    y = (y * slot_w[..., None].to(y.dtype)).reshape(e * c, d)
    y = _constrain(y, cons.get("flat"))
    out = _constrain(segment_sum(y, slot_tok, t), cons.get("tokens"))
    return out.to(x.dtype)


def moe_ffn(x, p, cfg: TransformerConfig, capacity: Optional[int] = None,
            shardings=None):
    """Capacity-based top-k MoE with gather dispatch (no [T,E,C] one-hots).

    x [T, D] flattened tokens -> [T, D]. Assignments past an expert's
    capacity go to a dump slot and are dropped; an empty slot gathers
    token 0 with weight 0, as in the reference. ``shardings`` (a dict of
    ``NamedSharding``s for "xs", "h", "flat" and "tokens") constrains
    the dispatch buffers as the reference's does.
    """
    t, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    topv, topi = moe_route(x, p["router"], k)
    if capacity is None:
        capacity = int(np.ceil(t * k / e * cfg.capacity_factor))
    slot_tok, slot_w = moe_slots(topv, topi, max(capacity, 1), 0, e)
    return moe_experts(x, p, slot_tok, slot_w, shardings)


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
        return moe_ffn(hn.reshape(b * s, d), lp, cfg,
                       shardings=moe_shardings).reshape(b, s, d)
    return dense_ffn(hn, lp)


def _project_qkv(hn, lp, cfg, q_pos):
    b, s, _ = hn.shape
    q = (hn @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    kk = (hn @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    vv = (hn @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
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
            act_constraint=None, moe_shardings=None):
    """Training forward: tokens [B, S] -> normed hidden [B, S, D].

    ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint``.
    """
    tokens, h = _embed(params, tokens, compute_dtype)
    b, s = tokens.shape
    q_pos = torch.arange(s, device=h.device)

    def layer(h, lp):
        # the reference's sequence-parallel residual stream constraint
        h = _constrain(h, act_constraint)
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


def logits_fn(params, h, cfg: TransformerConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


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
                compute_dtype=torch.bfloat16, moe_shardings=None):
    """One decode step: tokens [B, 1] -> (logits [B, 1, V], new cache).

    Consumes ``cache``: its ``k``, ``v`` and ``pos`` are written in place
    (the new token's slot, ``index % t_buf``) and are the new cache's,
    as the reference's decode reuses a donated cache. ``index`` is a new
    tensor. No host sync but the MoE combine's plan."""
    tokens, h = _embed(params, tokens, compute_dtype)
    b = tokens.shape[0]
    t_buf = cache["k"].shape[2]
    pos = cache["index"]                       # absolute position of token
    q_pos = pos.reshape(1).to(torch.int32)     # [1]
    slot = torch.remainder(pos, t_buf).reshape(1).long()

    new_pos = cache["pos"]
    new_pos.index_copy_(1, slot, q_pos.expand(b, 1).contiguous())
    kv_valid = new_pos >= 0

    layers = _layers(params, cfg, compute_dtype, layer_mode)
    for i, lp in enumerate(layers):
        kc, vc = cache["k"][i], cache["v"][i]
        hn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, kk, vv = _project_qkv(hn, lp, cfg, q_pos)
        kc.index_copy_(1, slot, kk.to(kc.dtype))
        vc.index_copy_(1, slot, vv.to(vc.dtype))
        attn = chunked_attention(q, kc, vc, q_pos=q_pos, kv_pos=new_pos,
                                 kv_valid=kv_valid, causal=True,
                                 window=cfg.sliding_window,
                                 q_chunk=1, k_chunk=k_chunk)
        h = h + attn.reshape(b, 1, -1) @ lp["wo"]
        h = h + _ffn(h, lp, cfg, moe_shardings)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, h, cfg)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": new_pos,
                 "index": pos + 1}
    return logits, new_cache


@torch.no_grad()
def prefill(params, tokens, cfg: TransformerConfig, *, max_len: int,
            q_chunk: int = 512, k_chunk: int = 1024,
            cache_dtype=torch.bfloat16, layer_mode: str = "scan",
            compute_dtype=torch.bfloat16, moe_shardings=None):
    """Prefill the prompt, return (normed hidden [B,S,D], cache)."""
    tokens, h = _embed(params, tokens, compute_dtype)
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
    for i, lp in enumerate(_layers(params, cfg, compute_dtype, layer_mode)):
        hn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, kk, vv = _project_qkv(hn, lp, cfg, q_pos)
        attn = chunked_attention(q, kk, vv, q_pos=q_pos, kv_pos=q_pos,
                                 causal=True, window=cfg.sliding_window,
                                 q_chunk=q_chunk, k_chunk=k_chunk)
        h = h + attn.reshape(b, s, -1) @ lp["wo"]
        k_all[i, :, :keep] = kk[:, s - keep:].to(cache_dtype)
        v_all[i, :, :keep] = vv[:, s - keep:].to(cache_dtype)
        h = h + _ffn(h, lp, cfg, moe_shardings)
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
