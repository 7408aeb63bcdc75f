"""Flash attention in plain PyTorch with a hand-written backward (port of
``repro.models.attention``).

Forward: online softmax over (q_chunk x k_chunk) tiles, in the
reference's order (q chunks outer, k chunks inner). Backward
(``torch.autograd.Function``): saves only (q, k, v, out, lse) and
recomputes each probability tile from ``lse``, k chunks outer and q
chunks inner, so attention's backward memory is O(inputs).

Supports GQA (kv heads < q heads; head h reads kv head h // G), causal
masking, sliding windows, and ring-buffer caches via absolute
(q_pos, kv_pos) + kv_valid masking.

Every score and product tile is taken with f32 accumulation and an f32
result, as the reference's ``preferred_element_type=jnp.float32``: f32
operands multiply in f32; bf16 operands go through
``torch.bmm(..., out_dtype=torch.float32)`` on the card (tensor cores,
f32 accumulator) and are upcast to f32 on the CPU (bf16 products are
exact in f32), where that form of ``bmm`` does not exist.

The tile loops are ``analysis.op_trace.tiles``: ``range`` on real
tensors; under the dry-run's fake tensors two tiles run and the second
one's ops are counted for every later tile (every tile dispatches the
same ops on the same shapes).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analysis.op_trace import tiles

NEG_INF = -1e30


def _mask(qpos_i, kpos_j, kval_j, causal, window):
    """[B, qc, kc] mask from absolute positions."""
    m = kval_j[:, None, :]
    if causal:
        m = m & (kpos_j[:, None, :] <= qpos_i[None, :, None])
    if window is not None:
        m = m & ((qpos_i[None, :, None] - kpos_j[:, None, :]) < window)
    return m


def _mm(a, b):
    """f32 ``a @ b`` of [B, KV, m, k] and [B, KV, k, n] tiles, f32
    accumulation whatever the operands' dtype: ``bmm(out_dtype=f32)`` off
    the CPU (the card; the meta device, where the dry-run traces the
    card's path without one), f32 copies on the CPU, which has no such
    ``bmm``."""
    bb, kv = a.shape[:2]
    a3, b3 = a.flatten(0, 1), b.flatten(0, 1)
    if a3.device.type != "cpu" and a3.dtype == b3.dtype != torch.float32:
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
    else:
        out = torch.bmm(a3.float(), b3.float())
    return out.view(bb, kv, *out.shape[1:])


class _Attention(torch.autograd.Function):
    """Chunked attention over pre-laid-out operands: q [B, KV, Sp*G, D]
    (rows in (position, group) order), k, v [B, KV, Tp, D]; positions
    qpos [Sp], kpos and kval [B, Tp]. Sp and Tp are whole chunks."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, kval, geo):
        qc, kc, g, causal, window, scale = geo
        b, kvh, rows, dh = q.shape
        nq, nk = rows // (qc * g), k.shape[2] // kc
        out = torch.empty_like(q)
        lse = q.new_empty((b, kvh, rows // g, g), dtype=torch.float32)
        for i in tiles(nq, q):
            qi = q[:, :, i * qc * g:(i + 1) * qc * g]
            qpos_i = qpos[i * qc:(i + 1) * qc]
            m = q.new_full((b, kvh, qc, g), NEG_INF, dtype=torch.float32)
            l = q.new_zeros((b, kvh, qc, g), dtype=torch.float32)
            acc = q.new_zeros((b, kvh, qc, g, dh), dtype=torch.float32)
            for j in tiles(nk, q):
                cols = slice(j * kc, (j + 1) * kc)
                vj = v[:, :, cols]
                sc = _mm(qi, k[:, :, cols].mT).view(b, kvh, qc, g, kc) \
                    * scale
                msk = _mask(qpos_i, kpos[:, cols], kval[:, cols], causal,
                            window)[:, None, :, None, :]
                sc = torch.where(msk, sc, NEG_INF)
                m_new = torch.maximum(m, sc.amax(dim=-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[..., None])
                l = l * corr + p.sum(dim=-1)
                # p is cast down to the kv dtype for the product and
                # accumulated in f32 (flash-standard), as the reference
                pv = _mm(p.to(vj.dtype).view(b, kvh, qc * g, kc),
                         vj).view(b, kvh, qc, g, dh)
                acc = acc * corr[..., None] + pv
                m = m_new
            l_safe = torch.clamp(l, min=1e-30)
            out[:, :, i * qc * g:(i + 1) * qc * g] = (
                acc / l_safe[..., None]).to(q.dtype).view(b, kvh, qc * g,
                                                         dh)
            lse[:, :, i * qc:(i + 1) * qc] = m + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, qpos, kpos, kval, out, lse)
        ctx.geo = geo
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        q, k, v, qpos, kpos, kval, out, lse = ctx.saved_tensors
        qc, kc, g, causal, window, scale = ctx.geo
        b, kvh, rows, dh = q.shape
        nq, nk = rows // (qc * g), k.shape[2] // kc
        g_out = g_out.contiguous()
        delta = torch.sum(g_out.float() * out.float(), dim=-1).view(
            b, kvh, rows // g, g)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        for j in tiles(nk, q):
            cols = slice(j * kc, (j + 1) * kc)
            kj, vj = k[:, :, cols], v[:, :, cols]
            dk_j = k.new_zeros((b, kvh, kc, dh), dtype=torch.float32)
            dv_j = torch.zeros_like(dk_j)
            for i in tiles(nq, q):
                qrows = slice(i * qc * g, (i + 1) * qc * g)
                qi, go_i = q[:, :, qrows], g_out[:, :, qrows]
                qpos_i = qpos[i * qc:(i + 1) * qc]
                lse_i = lse[:, :, i * qc:(i + 1) * qc]
                delta_i = delta[:, :, i * qc:(i + 1) * qc]
                sc = _mm(qi, kj.mT).view(b, kvh, qc, g, kc) * scale
                msk = _mask(qpos_i, kpos[:, cols], kval[:, cols], causal,
                            window)[:, None, :, None, :]
                sc = torch.where(msk, sc, NEG_INF)
                p = torch.exp(sc - lse_i[..., None])           # recomputed
                pl = p.to(vj.dtype).view(b, kvh, qc * g, kc)
                dv_j = dv_j + _mm(pl.mT, go_i)
                dp = _mm(go_i, vj.mT).view(b, kvh, qc, g, kc)
                ds = p * (dp - delta_i[..., None]) * scale
                dsl = ds.to(kj.dtype).view(b, kvh, qc * g, kc)
                dq[:, :, qrows] += _mm(dsl, kj)
                dk_j = dk_j + _mm(dsl.mT, qi)
            dk[:, :, cols] = dk_j
            dv[:, :, cols] = dv_j
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def chunked_attention(q, k, v, *, q_pos, kv_pos, kv_valid=None,
                      causal=True, window: Optional[int] = None,
                      q_chunk: int = 512, k_chunk: int = 1024):
    """q [B,S,H,Dh]; k,v [B,T,KV,Dh]; q_pos [S]; kv_pos [T] or [B,T].
    Returns [B,S,H,Dh]."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / np.sqrt(dh)
    dev = q.device

    q_pos = torch.as_tensor(q_pos, device=dev)
    kv_pos = torch.as_tensor(kv_pos, device=dev)
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None, :].expand(b, t)
    kv_valid = (torch.ones((b, t), dtype=torch.bool, device=dev)
                if kv_valid is None else torch.as_tensor(kv_valid,
                                                         device=dev))

    qc, kc = min(q_chunk, s), min(k_chunk, t)
    sp, tp = -(-s // qc) * qc, -(-t // kc) * kc

    qp = F.pad(q, (0, 0, 0, 0, 0, sp - s)) if sp > s else q
    kp = F.pad(k, (0, 0, 0, 0, 0, tp - t)) if tp > t else k
    vp = F.pad(v, (0, 0, 0, 0, 0, tp - t)) if tp > t else v
    qpos = F.pad(q_pos, (0, sp - s)) if sp > s else q_pos
    kpos = F.pad(kv_pos, (0, tp - t)) if tp > t else kv_pos
    kval = F.pad(kv_valid, (0, tp - t)) if tp > t else kv_valid

    # [B, KV, Sp*G, D]: q heads grouped under their kv head (h // G)
    qs = qp.reshape(b, sp, kvh, g, dh).permute(0, 2, 1, 3, 4).reshape(
        b, kvh, sp * g, dh)
    ks = kp.permute(0, 2, 1, 3).contiguous()                # [B, KV, Tp, D]
    vs = vp.permute(0, 2, 1, 3).contiguous()
    geo = (qc, kc, g, causal, window, scale)
    out = _Attention.apply(qs, ks, vs, qpos.contiguous(), kpos.contiguous(),
                           kval.contiguous(), geo)
    out = out.reshape(b, kvh, sp, g, dh).permute(0, 2, 1, 3, 4).reshape(
        b, sp, h, dh)
    return out[:, :s]
