"""DimeNet [arXiv:2003.03123] — directional message passing over triplets
(port of ``repro.models.dimenet``).

Messages live on directed edges, and each interaction block updates edge
kj's message from all edges (k->j) sharing its target, weighted by a
joint radial+angular basis of (d_kj, angle(kj, ji)). This is a gather
over a triplet index list and a segment reduction, not an SpMM: the
port runs it through ``models.common.take`` and ``segment_sum``, whose
sums (forward and backward) follow host-built plans, so a training step
repeats bit for bit on the card.

The reference replaces the spherical Bessel/Legendre joint basis with an
equivalent-rank separable basis
  rbf_n(d) = env(d) * sin((n+1) pi d / c) / d,   cbf_l(a) = cos(l * a)
which preserves shapes, sparsity pattern and FLOP structure (n_radial x
n_spherical bilinear expansion); the port keeps it.
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

N_SPECIES = 16  # atomic-number embedding rows (H..S for molecule bench)


class MoleculeBatch(NamedTuple):
    """Batched small molecules, flattened with segment ids."""

    z: torch.Tensor          # [N] atom types
    pos: torch.Tensor        # [N, 3]
    edge_src: torch.Tensor   # [E]  (k in k->j)
    edge_dst: torch.Tensor   # [E]  (j)
    trip_kj: torch.Tensor    # [T] edge index of (k->j)
    trip_ji: torch.Tensor    # [T] edge index of (j->i)
    mol_id: torch.Tensor     # [N] molecule segment of each atom
    n_mols: int


def build_triplets(edge_src: np.ndarray, edge_dst: np.ndarray):
    """All ordered pairs of edges (k->j, j->i) with k != i (host-side)."""
    kj, ji = [], []
    by_src = {}
    for eid, s in enumerate(edge_src):
        by_src.setdefault(int(s), []).append(eid)
    for e_kj, (k, j) in enumerate(zip(edge_src, edge_dst)):
        for e_ji in by_src.get(int(j), ()):
            if int(edge_dst[e_ji]) != int(k):   # exclude backtracking k->j->k
                kj.append(e_kj)
                ji.append(e_ji)
    return (np.asarray(kj, np.int32), np.asarray(ji, np.int32))


def envelope(d, cutoff, p=6):
    """DimeNet polynomial envelope u(d) with u(c)=u'(c)=u''(c)=0."""
    x = d / cutoff
    a, b, c = -(p + 1) * (p + 2) / 2, p * (p + 2), -p * (p + 1) / 2
    return (1 / torch.clamp(x, min=1e-9) + a * x ** (p - 1) + b * x ** p
            + c * x ** (p + 1)) * (x < 1.0).to(x.dtype)


def radial_basis(d, n_radial, cutoff):
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    env = envelope(d, cutoff)[:, None]
    return env * torch.sin(n[None, :] * np.pi * d[:, None] / cutoff) \
        * np.sqrt(2.0 / cutoff)


def angular_basis(d, angle, n_spherical, n_radial, cutoff):
    """Separable radial x angular expansion [T, n_spherical * n_radial]."""
    rb = radial_basis(d, n_radial, cutoff)                 # [T, R]
    l = torch.arange(n_spherical, dtype=torch.float32, device=d.device)
    cb = torch.cos(l[None, :] * angle[:, None])            # [T, S]
    return (rb[:, None, :] * cb[:, :, None]).reshape(d.shape[0], -1)


def dimenet_init(cfg: GNNConfig, gen: torch.Generator, device="cuda"):
    """Parameters drawn from ``gen`` (on its device), then placed on
    ``device``: a dict with lists of blocks and ``(w, b)`` MLP layers,
    the reference's tree."""
    d = cfg.d_hidden
    nr, ns, nb = cfg.n_radial, cfg.n_spherical, cfg.n_bilinear
    p = {
        "emb_z": normal_init(gen, (N_SPECIES, d)),
        "emb_rbf": uniform_init(gen, (nr, d)),
        "emb_msg": init_mlp(gen, [3 * d, d]),
        "out_rbf": uniform_init(gen, (nr, d)),
        "out_mlp": init_mlp(gen, [d, d, 1]),
        "blocks": [],
    }
    for _ in range(cfg.n_layers):
        p["blocks"].append({
            "w_rbf": uniform_init(gen, (nr, d)),
            "w_src": init_mlp(gen, [d, d]),
            "w_pre": init_mlp(gen, [d, nb]),          # down-project msg
            "w_sbf": uniform_init(gen, (ns * nr, nb, d)),  # bilinear
            "w_upd": init_mlp(gen, [d, d, d]),
            "w_res": init_mlp(gen, [d, d]),
        })
    return _placed(p, device)


def _bilinear(sbf, w_sbf, pre):
    """``einsum("ts,sbd,tb->td", sbf, w_sbf, pre)`` in one fixed order:
    the [T, S*R*nb] outer product, then one GEMM with w_sbf. XLA and
    torch's einsum may contract the three in other orders, so f32
    results agree with the reference to rounding, not bit for bit."""
    t, s = sbf.shape
    outer = (sbf[:, :, None] * pre[:, None, :]).reshape(t, -1)
    return outer @ w_sbf.reshape(s * w_sbf.shape[1], w_sbf.shape[2])


def dimenet_forward(params, batch: MoleculeBatch, cfg: GNNConfig,
                    constrain=None, gops=None, remat=False):
    """Returns per-molecule energies [n_mols]."""
    c = constrain or (lambda x, kind: x)
    tk, seg = gops or default_gops()
    vec = tk(batch.pos, batch.edge_src) \
        - tk(batch.pos, batch.edge_dst)                    # [E, 3]
    d = torch.sqrt(torch.sum(vec ** 2, dim=-1) + 1e-12)
    rbf = radial_basis(d, cfg.n_radial, cfg.cutoff)        # [E, R]

    # triplet angle between edge kj and edge ji
    v_kj = tk(vec, batch.trip_kj)
    v_ji = tk(vec, batch.trip_ji)
    cosang = torch.sum(v_kj * v_ji, dim=-1) / (
        torch.linalg.vector_norm(v_kj, dim=-1)
        * torch.linalg.vector_norm(v_ji, dim=-1) + 1e-9)
    # arccos has an unbounded derivative at +-1, and at the bounds
    # torch.clamp's gradient (1) is not jnp.clip's; random molecules
    # reach neither (no two collinear edges)
    angle = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    sbf = angular_basis(tk(d, batch.trip_kj), angle,
                        cfg.n_spherical, cfg.n_radial, cfg.cutoff)

    # embedding block: directed edge message m_kj
    zs = take(params["emb_z"], batch.z)
    m = mlp(torch.cat([tk(zs, batch.edge_src), tk(zs, batch.edge_dst),
                       rbf @ params["emb_rbf"]], dim=-1),
            params["emb_msg"], activation=F.silu)          # [E, d]

    n_edges = m.shape[0]
    sbf = c(sbf, "edge")
    m = c(m, "edge")

    def block(m, blk):
        # directional interaction: gather messages of k->j, expand in the
        # joint basis, reduce onto edge j->i (the triplet gather)
        m_kj = tk(m, batch.trip_kj)                        # [T, d]
        pre = mlp(m_kj, blk["w_pre"], activation=F.silu)   # [T, nb]
        t_msg = c(_bilinear(sbf, blk["w_sbf"], pre), "edge")   # [T, d]
        agg = c(seg(t_msg, batch.trip_ji, n_edges), "edge")
        upd = (rbf @ blk["w_rbf"]) * mlp(m, blk["w_src"],
                                         activation=F.silu) + agg
        return c(mlp(m + mlp(upd, blk["w_upd"], activation=F.silu),
                     blk["w_res"], activation=F.silu), "edge")

    for blk in params["blocks"]:
        m = (checkpoint(block, m, blk, use_reentrant=False) if remat
             else block(m, blk))

    # output block: edges -> atoms -> molecule energy
    per_atom = c(seg((rbf @ params["out_rbf"]) * m, batch.edge_dst,
                     batch.z.shape[0]), "node")
    energy_atom = mlp(per_atom, params["out_mlp"],
                      activation=F.silu)[:, 0]
    e = segment_sum(energy_atom, batch.mol_id, batch.n_mols)
    return molecule_sums(e, gops)
