"""Factorization Machine [Rendle, ICDM'10] (port of ``repro.models.fm``).

score(x) = w0 + sum_i w_i x_i + sum_{i<j} <v_i, v_j> x_i x_j
with the pairwise term computed by the O(nk) sum-square identity
  sum_{i<j} <v_i,v_j> = 0.5 * ((sum_i v_i)^2 - sum_i v_i^2) . 1

Embedding tables are one concatenated [total_vocab, k] array with static
per-field offsets. The lookup is ``models.common.take``: a gather whose
gradient sums onto the table's rows by a host-built plan, so a training
step repeats bit for bit on the card (no ``index_add_``, no
``F.embedding``); with no gradient recorded it is the gather alone.

``retrieval_score`` exploits the FM decomposition
  score(u, c) = [w0 + lin_u + pair_u] + [lin_c + pair_c] + <s_u, s_c>
(s = sum of field vectors) to score 1M candidates as one batched matvec
instead of a loop.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import resolve_device

from .common import normal_init, take


def field_offsets(cfg: RecsysConfig) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(cfg.vocab_sizes)])[:-1].astype(
        np.int32)


def fm_init(cfg: RecsysConfig, gen: torch.Generator, device="cuda"):
    """``v`` [total, k] and ``w`` [total, 1] ~ N(0, 0.01²) drawn from
    ``gen`` on its device, ``w0`` = 0; placed on ``device``."""
    dev = resolve_device(device)
    total = int(sum(cfg.vocab_sizes))
    return {
        "v": normal_init(gen, (total, cfg.embed_dim), stddev=0.01).to(dev),
        "w": normal_init(gen, (total, 1), stddev=0.01).to(dev),
        "w0": torch.zeros((), device=dev),
    }


def _flat_ids(idx, cfg, device) -> torch.Tensor:
    offs = torch.as_tensor(field_offsets(cfg), device=device)
    return torch.as_tensor(idx, device=device) + offs[None, :]


def fm_score(params, idx, cfg: RecsysConfig, lookup=take):
    """idx [B, n_fields] per-field ids -> scores [B]. ``lookup(table,
    ids)``: the rows of ``table`` at ``ids`` (``take``; a rank's block
    of a sharded table: ``distributed.rows``)."""
    flat = _flat_ids(idx, cfg, params["v"].device)         # [B, F]
    v = lookup(params["v"], flat)                          # [B, F, k]
    lin = lookup(params["w"][:, 0], flat).sum(-1)
    s = v.sum(dim=1)                                       # [B, k]
    pair = 0.5 * (torch.square(s) - torch.square(v).sum(dim=1)).sum(-1)
    return params["w0"] + lin + pair


def fm_loss(params, idx, labels, cfg: RecsysConfig, lookup=take,
            n_total=None):
    """The mean BCE over ``n_total`` examples (default: this batch's);
    with a larger ``n_total``, this block's share of the mean."""
    logits = fm_score(params, idx, cfg, lookup)
    labels = torch.as_tensor(labels, device=logits.device)
    n = logits.shape[0] if n_total is None else n_total
    return torch.sum(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))) / n  # stable BCE


def retrieval_score(params, user_idx, cand_idx, cfg: RecsysConfig,
                    n_user_fields: int, user_lookup=take, cand_lookup=take):
    """user_idx [F_u] ids (already offset-flat fields 0..F_u),
    cand_idx [M, F_c] ids (offset-flat fields F_u..) -> [M] scores.
    ``user_lookup`` / ``cand_lookup``: as ``fm_score``'s ``lookup``."""
    dev = params["v"].device
    user_idx = torch.as_tensor(user_idx, device=dev)
    cand_idx = torch.as_tensor(cand_idx, device=dev)
    w = params["w"][:, 0]
    vu = user_lookup(params["v"], user_idx)                # [F_u, k]
    su = vu.sum(dim=0)                                     # [k]
    lin_u = user_lookup(w, user_idx).sum()
    pair_u = 0.5 * (torch.square(su) - torch.square(vu).sum(0)).sum()

    vc = cand_lookup(params["v"], cand_idx)                # [M, F_c, k]
    sc = vc.sum(dim=1)                                     # [M, k]
    lin_c = cand_lookup(w, cand_idx).sum(-1)
    pair_c = 0.5 * (torch.square(sc) - torch.square(vc).sum(1)).sum(-1)

    cross = sc @ su                                        # [M]
    return params["w0"] + lin_u + pair_u + lin_c + pair_c + cross


def fm_score_ref(params, idx, cfg: RecsysConfig):
    """O(F^2 k) explicit-pairwise oracle for tests."""
    flat = _flat_ids(idx, cfg, params["v"].device)
    v = take(params["v"], flat)                            # [B, F, k]
    lin = take(params["w"][:, 0], flat).sum(-1)
    gram = torch.einsum("bik,bjk->bij", v, v)
    f = v.shape[1]
    iu = torch.triu_indices(f, f, offset=1, device=v.device)
    pair = gram[:, iu[0], iu[1]].sum(-1)
    return params["w0"] + lin + pair
