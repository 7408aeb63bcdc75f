"""Message-passing GNNs: vanilla GCN (the paper's model), GatedGCN, and
MeshGraphNet (port of ``repro.models.gnn``).

Message passing is an edge-index gather plus a segment sum over
receivers, as in the reference. The default ops (``default_gops``) are
``models.common.take`` and ``segment_sum``: each sum, forward and
backward, runs in a fixed order from a host-built ``SegmentPlan``, so a
training step repeats bit for bit on the card. The GCN can instead run
its aggregation through the paper's TriPartition
(``repro_torch.core.hybrid_spmm``) when the graph has been
preprocessed. ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map

from .common import (init_mlp, layer_norm, mlp, segment_sum, take,
                     uniform_init)


class Graph(NamedTuple):
    """COO edge-list graph. senders/receivers [E]; features optional."""

    senders: torch.Tensor
    receivers: torch.Tensor
    node_feat: torch.Tensor                   # [N, F]
    edge_feat: Optional[torch.Tensor] = None  # [E, Fe]

    @property
    def n_nodes(self):
        return self.node_feat.shape[0]

    @property
    def n_edges(self):
        return self.senders.shape[0]


def default_gops():
    """(take, segment_sum): gather rows, and sum rows onto segments, both
    deterministic in both directions (``models.common``)."""
    return take, segment_sum


def molecule_sums(e, gops):
    """Per-molecule sums ``e`` of this rank's atoms as every rank's: under
    the halo ops (``gops.group``) summed over the group
    (``distributed.tp.psum``, whose backward sums each rank's share of
    the loss's cotangent); unchanged otherwise."""
    group = getattr(gops, "group", None)
    if group is None:
        return e
    from repro_torch.distributed.tp import psum
    return psum(e, group)


def symmetric_normalized_weights(g: Graph, gops=None) -> torch.Tensor:
    """GCN edge weights  d_i^{-1/2} d_j^{-1/2}  (self-loops NOT added here)."""
    tk, seg = gops or default_gops()
    n = g.n_nodes
    ones = torch.ones(g.n_edges, dtype=torch.float32,
                      device=g.node_feat.device)
    deg = seg(ones, g.receivers, n)
    dinv = torch.rsqrt(torch.clamp(deg, min=1.0))
    return tk(dinv, g.senders) * tk(dinv, g.receivers)


def _placed(params, device):
    dev = resolve_device(device)
    return tree_map(lambda p: p.to(dev), params)


# ------------------------------------------------------------- GCN ---------
def gcn_init(cfg: GNNConfig, d_in: int, gen: torch.Generator,
             device="cuda"):
    dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return _placed({"w": [uniform_init(gen, (di, do))
                          for di, do in zip(dims[:-1], dims[1:])]}, device)


def gcn_forward(params, g: Graph, cfg: GNNConfig,
                edge_weights: Optional[torch.Tensor] = None, constrain=None,
                gops=None):
    """Combination-first  A_norm @ (X @ W)  per layer (paper §II-A)."""
    c = constrain or (lambda x, kind: x)
    tk, seg = gops or default_gops()
    n = g.n_nodes
    w_e = edge_weights if edge_weights is not None \
        else symmetric_normalized_weights(g, gops)
    h = g.node_feat
    for i, w in enumerate(params["w"]):
        h = c(h @ w, "node")                              # combination first
        msgs = c(w_e[:, None] * tk(h, g.senders), "edge")
        h = c(seg(msgs, g.receivers, n), "node") + h
        if i < len(params["w"]) - 1:
            h = torch.relu(h)
    return h


# --------------------------------------------------------- GatedGCN --------
def gatedgcn_init(cfg: GNNConfig, d_in: int, d_edge_in: int,
                  gen: torch.Generator, device="cuda"):
    d = cfg.d_hidden
    p = {
        "embed_h": uniform_init(gen, (d_in, d)),
        "embed_e": uniform_init(gen, (max(d_edge_in, 1), d)),
        "readout": uniform_init(gen, (d, cfg.n_classes)),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        lp = {k: uniform_init(gen, (d, d)) for k in "ABCUV"}
        lp.update(ln_h_s=torch.ones(d), ln_h_b=torch.zeros(d),
                  ln_e_s=torch.ones(d), ln_e_b=torch.zeros(d))
        p["layers"].append(lp)
    return _placed(p, device)


def _edge_input(g: Graph) -> torch.Tensor:
    if g.edge_feat is not None:
        return g.edge_feat
    return torch.ones((g.n_edges, 1), dtype=torch.float32,
                      device=g.node_feat.device)


def _layers(layer, h, e, layers, remat):
    for lp in layers:
        if remat:
            h, e = checkpoint(layer, (h, e), lp, use_reentrant=False)
        else:
            h, e = layer((h, e), lp)
    return h


def gatedgcn_forward(params, g: Graph, cfg: GNNConfig, constrain=None,
                     gops=None, remat=False):
    c = constrain or (lambda x, kind: x)
    tk, seg = gops or default_gops()
    n = g.n_nodes
    h = g.node_feat @ params["embed_h"]
    e = _edge_input(g) @ params["embed_e"]

    def layer(carry, lp):
        h, e = carry
        h = c(h, "node")   # also pins the bwd scatter-add's cotangent
        hs = tk(h, g.senders)
        hr = tk(h, g.receivers)
        e_hat = c(hr @ lp["A"] + hs @ lp["B"] + e @ lp["C"], "edge")
        e = e + torch.relu(layer_norm(e_hat, lp["ln_e_s"], lp["ln_e_b"]))
        eta = torch.sigmoid(e_hat)                        # [E, d] vector gates
        num = c(seg(eta * (hs @ lp["V"]), g.receivers, n), "node")
        den = c(seg(eta, g.receivers, n), "node") + 1e-6
        agg = h @ lp["U"] + num / den
        h = h + torch.relu(layer_norm(agg, lp["ln_h_s"], lp["ln_h_b"]))
        return (h, e)

    h = _layers(layer, h, e, params["layers"], remat)
    return h @ params["readout"]


# ----------------------------------------------------- MeshGraphNet --------
def _mgn_mlp_init(gen, d_in, d_hidden, d_out, n_hidden=2):
    dims = [d_in] + [d_hidden] * n_hidden + [d_out]
    return init_mlp(gen, dims)


def meshgraphnet_init(cfg: GNNConfig, d_in: int, d_edge_in: int,
                      gen: torch.Generator, device="cuda"):
    d = cfg.d_hidden
    p = {
        "enc_h": _mgn_mlp_init(gen, d_in, d, d, cfg.mlp_layers),
        "enc_e": _mgn_mlp_init(gen, max(d_edge_in, 1), d, d,
                               cfg.mlp_layers),
        "dec": _mgn_mlp_init(gen, d, d, cfg.n_classes, cfg.mlp_layers),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        p["layers"].append({
            "edge": _mgn_mlp_init(gen, 3 * d, d, d, cfg.mlp_layers),
            "node": _mgn_mlp_init(gen, 2 * d, d, d, cfg.mlp_layers),
        })
    return _placed(p, device)


def meshgraphnet_forward(params, g: Graph, cfg: GNNConfig, constrain=None,
                         gops=None, remat=False):
    c = constrain or (lambda x, kind: x)
    tk, seg = gops or default_gops()
    n = g.n_nodes
    h = mlp(g.node_feat, params["enc_h"])
    e = mlp(_edge_input(g), params["enc_e"])

    def layer(carry, lp):
        h, e = carry
        h = c(h, "node")   # also pins the bwd scatter-add's cotangent
        hs = tk(h, g.senders)
        hr = tk(h, g.receivers)
        e = e + c(mlp(torch.cat([e, hs, hr], dim=-1), lp["edge"]), "edge")
        agg = c(seg(e, g.receivers, n), "node")
        h = h + mlp(torch.cat([h, agg], dim=-1), lp["node"])
        return (h, e)

    h = _layers(layer, h, e, params["layers"], remat)
    return mlp(h, params["dec"])
