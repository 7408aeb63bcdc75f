"""NequIP [arXiv:2101.03164] — E(3)-equivariant interatomic potential
(port of ``repro.models.nequip``).

Features are irrep-indexed: ``h[l]`` has shape [N, C, 2l+1] for l=0..l_max.
Each interaction layer:

  1. radial basis R(d) -> per-path weights via a radial MLP
  2. edge tensor product  (h_j[l1] (x) Y_l2(r_ij)) -> l3   using the real
     Clebsch-Gordan tensors of ``so3`` (placed on the device once per
     path, ``so3.cg_tensor``)
  3. segment sum over receivers (``models.common.segment_sum``, by plan)
  4. per-l channel-mixing linear + gated nonlinearity (scalars gate the
     norms of higher-l features)

Readout: the l=0 channels -> MLP -> per-atom energy -> per-molecule sum.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig

from .common import (init_mlp, mlp, normal_init, segment_sum, take,
                     uniform_init)
from .gnn import _placed, default_gops, molecule_sums
from .so3 import cg_tensor, spherical_harmonics

N_SPECIES = 16


class AtomGraph(NamedTuple):
    z: torch.Tensor         # [N] species
    pos: torch.Tensor       # [N, 3]
    edge_src: torch.Tensor  # [E] j (source / neighbor)
    edge_dst: torch.Tensor  # [E] i (target / center)
    mol_id: torch.Tensor    # [N]
    n_mols: int


def _paths(l_max: int):
    """All (l1_in, l2_sh, l3_out) tensor-product paths up to l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                out.append((l1, l2, l3))
    return out


def radial_basis(d, n_rbf, cutoff):
    """Bessel radial basis with smooth cosine cutoff envelope."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    cut = 0.5 * (torch.cos(np.pi * torch.clamp(d / cutoff, 0, 1)) + 1.0)
    return (torch.sin(n[None, :] * np.pi * d[:, None] / cutoff)
            / torch.clamp(d[:, None], min=1e-9)) * cut[:, None]


def nequip_init(cfg: GNNConfig, gen: torch.Generator, device="cuda"):
    """Parameters drawn from ``gen`` (on its device), then placed on
    ``device``: the reference's tree (dicts, lists, ``(w, b)`` MLP
    layers)."""
    c, lm = cfg.d_hidden, cfg.l_max
    paths = _paths(lm)
    p = {
        "emb_z": normal_init(gen, (N_SPECIES, c)),
        "readout": init_mlp(gen, [c, c, 1]),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        p["layers"].append({
            # radial MLP -> one weight set per path per channel
            "radial": init_mlp(gen, [cfg.n_rbf, c, len(paths) * c]),
            "self": [uniform_init(gen, (c, c)) for _ in range(lm + 1)],
            "gate": uniform_init(gen, (c, c * lm)),
        })
    return _placed(p, device)


def _couple(hj, sh, cg):
    """``einsum("eca,eb,abm->ecm", hj, sh, cg)`` in one fixed order: Y
    with the CG tensor first ([E, a, m]), then a batched product with
    the gathered features. f32 results agree with the reference's to
    rounding, not bit for bit."""
    e, a, b = hj.shape[0], cg.shape[0], cg.shape[1]
    ycg = (sh @ cg.permute(1, 0, 2).reshape(b, -1)).reshape(e, a, -1)
    return torch.bmm(hj, ycg)


def nequip_forward(params, g: AtomGraph, cfg: GNNConfig, constrain=None,
                   gops=None, remat=False):
    """Returns per-molecule energies [n_mols]."""
    cn = constrain or (lambda x, kind: x)
    tk, seg = gops or default_gops()
    c, lm = cfg.d_hidden, cfg.l_max
    paths = _paths(lm)
    n = g.z.shape[0]
    dev = str(g.pos.device)

    vec = tk(g.pos, g.edge_src) - tk(g.pos, g.edge_dst)
    d = torch.linalg.vector_norm(vec, dim=-1)
    rbf = radial_basis(d, cfg.n_rbf, cfg.cutoff)          # [E, n_rbf]
    sh = spherical_harmonics(vec, lm)                     # l -> [E, 2l+1]
    cgs = [cg_tensor(l1, l2, l3, dev) for l1, l2, l3 in paths]

    h = {l: torch.zeros((n, c, 2 * l + 1), device=g.pos.device)
         for l in range(lm + 1)}
    h[0] = take(params["emb_z"], g.z)[:, :, None]

    def layer(h, lp):
        rw = mlp(rbf, lp["radial"], activation=F.silu)
        rw = rw.reshape(-1, len(paths), c)                # [E, P, C]

        h = {l: cn(h[l], "node") for l in range(lm + 1)}
        hj = {l: tk(h[l], g.edge_src) for l in range(lm + 1)}  # [E, C, 2l+1]
        msg = {}
        for pi, (l1, l2, l3) in enumerate(paths):
            # (h_j (x) Y) -> l3 with per-edge-per-channel radial weight
            t = rw[:, pi, :, None] * _couple(hj[l1], sh[l2], cgs[pi])
            msg[l3] = t if l3 not in msg else msg[l3] + t

        msg = {l: cn(msg[l], "edge") for l in range(lm + 1)}
        agg = {l: cn(seg(msg[l], g.edge_dst, n), "node")
               / np.sqrt(8.0) for l in range(lm + 1)}

        # self-interaction (channel mixing) + residual
        new_h = {l: h[l] + torch.einsum("ncm,cd->ndm", agg[l],
                                        lp["self"][l])
                 for l in range(lm + 1)}
        # gated nonlinearity: scalars pass through silu; higher l scaled by
        # a sigmoid gate computed from the scalar channel
        gates = torch.sigmoid(new_h[0][:, :, 0] @ lp["gate"])  # [N, C*lm]
        gates = gates.reshape(n, lm, c) if lm else None
        out_h = {0: F.silu(new_h[0])}
        for l in range(1, lm + 1):
            out_h[l] = new_h[l] * gates[:, l - 1, :, None]
        return out_h

    for lp in params["layers"]:
        h = (checkpoint(layer, h, lp, use_reentrant=False) if remat
             else layer(h, lp))

    e_atom = mlp(h[0][:, :, 0], params["readout"],
                 activation=F.silu)[:, 0]
    return molecule_sums(segment_sum(e_atom, g.mol_id, g.n_mols), gops)
