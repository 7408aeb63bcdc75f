"""Graph attention (GAT, Velickovic et al., arXiv:1710.10903) over the
tri-engine executor.

A layer of H heads of F' features each computes, for every head h,

    B = X W                                  (W [F_in, H * F'])
    s_i = B_i[h] . a_l[h],  t_j = B_j[h] . a_r[h]
    e_ij = LeakyReLU(s_i + t_j)              (negative slope 0.2)
    alpha_ij = softmax over j in N(i) of e_ij   (N(i): i's row of A + I)
    y_i[h] = sum_j alpha_ij B_j[h]

then concatenates the heads (or averages them, the output layer's
choice), applies ELU where the layer asks, and adds the layer's input
where it has a skip connection. The graph is served through the same
registration, shape class, partition, reduction plan and executor cache
as the GCN (``Engine.register(..., model="gat")``):

  xw     ``member_matmul`` X·W, then s and t for every node and head in
         one more product, B·[a_l | a_r] laid out block by head
         (``attention_matrix``);
  attn   each row's maximum and denominator over all its neighbours
         (``gat_coef.gat_row_stats``, over the row lists ``RowLists``),
         then the unnormalised coefficient exp(e_ij - m_i) of every
         stored entry of the three engines' layouts, per head
         (``gat_coef.gat_edge_coef``);
  dense, ell, coo
         the three engines with those H values an entry in place of the
         pattern's one, one launch each for all heads and the group
         (``ops.dense_heads_matmul`` / ``ell_heads_matmul`` /
         ``coo_heads_matmul``): column block h of B scaled by head h's
         value;
  out    the division by the row's denominator (0 where a row has no
         neighbour: class padding), ELU, the skip, the head mean.

One softmax a row: the engines see disjoint parts of a row's neighbours,
and all of them scale by the same exp(e_ij - m_i) and are divided by the
same d_i after their rows are added. Float32 throughout, TF32 off (X·W
as the GCN's). With a leading group axis the whole group runs with one
launch of each kernel a layer, and each member's logits are bitwise its
own G = 1 forward: every product is per member, every sum in a fixed
order.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import gat_coef
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (bsr_spmm_rows_ref, coo_rows_ref,
                                     gat_edge_coef_ref, gat_row_stats_ref,
                                     ragged_ell_rows_ref)

from .formats import (PartitionMeta, ReductionPlan, TriPartition,
                      b_tiles_of, pad_b_to_tiles, to_numpy)
from .hybrid_spmm import BACKENDS, _grouped, as_operand, member_matmul

NEGATIVE_SLOPE = 0.2


class GatLayer(NamedTuple):
    """One layer's parameters: ``w`` [F_in, H * F'], ``a_l`` / ``a_r``
    [H, F'] (the attention vector's halves for the destination and the
    source), and its structure: ``concat`` the heads (else average them),
    ``elu`` after the heads, ``skip``: add the layer's input after that
    (the widths must agree)."""

    w: object
    a_l: object
    a_r: object
    concat: bool = True
    elu: bool = True
    skip: bool = False


@dataclasses.dataclass(frozen=True)
class GatSpec:
    """The static structure of a GAT: heads, per-head widths and flags a
    layer. Hashable: it rides in executor and group keys."""

    heads: tuple
    widths: tuple     # F' a layer
    concat: tuple
    elu: tuple
    skip: tuple

    @property
    def out_width(self) -> int:
        h, f = self.heads[-1], self.widths[-1]
        return h * f if self.concat[-1] else f


def gat_spec(layers) -> GatSpec:
    """The ``GatSpec`` of a list of ``GatLayer``; ValueError where the
    shapes do not chain."""
    heads, widths = [], []
    f_prev = None
    for i, lay in enumerate(layers):
        h, f = tuple(np.shape(to_numpy(lay.a_l)))
        w = tuple(np.shape(to_numpy(lay.w)))
        if tuple(np.shape(to_numpy(lay.a_r))) != (h, f) or w[1] != h * f:
            raise ValueError(f"GAT layer {i}: w {w}, a_l {(h, f)}, a_r "
                             f"{tuple(np.shape(to_numpy(lay.a_r)))}")
        if f_prev is not None and w[0] != f_prev:
            raise ValueError(f"GAT layer {i} takes {w[0]} features, the "
                             f"layer before gives {f_prev}")
        out = h * f if lay.concat else f
        if lay.skip and out != w[0]:
            raise ValueError(f"GAT layer {i}: a skip needs {w[0]} == {out}")
        heads.append(int(h))
        widths.append(int(f))
        f_prev = out
    return GatSpec(tuple(heads), tuple(widths),
                   tuple(bool(lay.concat) for lay in layers),
                   tuple(bool(lay.elu) for lay in layers),
                   tuple(bool(lay.skip) for lay in layers))


def attention_matrix(a_l, a_r) -> torch.Tensor:
    """[H * F', 2H] float32: column h holds a_l[h] in rows h*F' ..
    (h+1)*F' - 1, column H + h holds a_r[h] there, zeros elsewhere, so
    that B · it = [s | t] for every node and head in one product."""
    a_l = torch.as_tensor(to_numpy(a_l), dtype=torch.float32)
    a_r = torch.as_tensor(to_numpy(a_r), dtype=torch.float32)
    h, f = a_l.shape
    att = torch.zeros((h * f, 2 * h), dtype=torch.float32)
    for k in range(h):
        att[k * f:(k + 1) * f, k] = a_l[k]
        att[k * f:(k + 1) * f, h + k] = a_r[k]
    return att


def gat_weights(layers) -> list:
    """The flat weight list an engine keeps for a GAT: W, then the
    attention matrix, a layer (float32 host tensors)."""
    out = []
    for lay in layers:
        out.append(torch.as_tensor(np.asarray(to_numpy(lay.w), np.float32)))
        out.append(attention_matrix(lay.a_l, lay.a_r))
    return out


class RowLists(NamedTuple):
    """Each row's neighbours in the class's padded row space: row g*P + i
    has ``cols[offsets[g*P+i] : offsets[g*P+i+1]]`` (columns of member g),
    rows past the graph's own none. What the row statistics walk."""

    offsets: object   # [G * P + 1] int64
    cols: object      # [E] int32


def row_lists(indptr, indices, p: int) -> RowLists:
    """One graph's ``RowLists`` (host numpy) over ``p`` padded rows, from
    its (reordered) CSR."""
    indptr = np.asarray(indptr, np.int64)
    n = indptr.shape[0] - 1
    if n > p:
        raise ValueError(f"{n} rows do not fit {p} padded rows")
    offsets = np.concatenate([indptr, np.full(p - n, indptr[-1], np.int64)])
    return RowLists(offsets, np.asarray(indices, np.int32))


def stack_row_lists(lists) -> RowLists:
    """Members' ``RowLists`` as one over the group axis."""
    offs, at = [np.zeros(1, np.int64)], 0
    for rl in lists:
        o = np.asarray(rl.offsets, np.int64)
        offs.append(o[1:] + at)
        at += int(o[-1])
    return RowLists(np.concatenate(offs),
                    np.concatenate([np.asarray(rl.cols, np.int32)
                                    for rl in lists]))


def row_lists_to(rl: RowLists, device) -> RowLists:
    return RowLists(torch.as_tensor(np.asarray(rl.offsets, np.int64)).to(
        device), torch.as_tensor(np.asarray(rl.cols, np.int32)).to(device))


def split_rows(part: TriPartition, meta: PartitionMeta) -> dict:
    """How many rows have neighbours in exactly two and in all three
    engines (a partition with the pattern's values): {"two": n, "three":
    m}, read on the host."""
    p, T = meta.n_padded_rows, meta.tile
    seen = np.zeros((3, p + 1), bool)
    tiles = to_numpy(part.dense.tiles)
    if tiles.size:
        live = (tiles != 0).any(-1)                            # [n_t, T]
        rows = to_numpy(part.dense.tile_row).astype(np.int64)[:, None] * T \
            + np.arange(T)
        seen[0, rows[live]] = True
    rows = to_numpy(part.ell.rows).astype(np.int64)
    if rows.size:
        live = (to_numpy(part.ell.vals) != 0).any(-1)
        seen[1, np.minimum(rows[live], p)] = True
    vals = to_numpy(part.coo.vals)
    if vals.size:
        seen[2, to_numpy(part.coo.rows).astype(np.int64)[vals != 0]] = True
    engines = seen[:, :p].sum(0)
    return {"two": int((engines == 2).sum()),
            "three": int((engines == 3).sum())}


def _aggregate(part, coef, b, meta, plan, backend, chain):
    """The three engines with multi-head values ``coef`` (dense, ell,
    coo layouts): [G, n_padded_rows, F] float32; ``chain`` marks
    ``dense``, ``ell`` and ``coo``."""
    dense, ell, coo = coef
    g, _, f = b.shape
    if backend == "cuda":
        y = kops.dense_heads_matmul(part, dense, b, meta, plan)
        if chain is not None:
            chain.mark("dense")
        y = kops.ell_heads_matmul(part, ell, b, meta, plan, y)
        if chain is not None:
            chain.mark("ell")
        y = kops.coo_heads_matmul(part, coo, b, meta, plan, y)
    else:
        bt = b_tiles_of(b, meta)
        y = bsr_spmm_rows_ref(dense, part.dense.tile_col, bt,
                              plan.dense).reshape(g, meta.n_padded_rows, f)
        if chain is not None:
            chain.mark("dense")
        if part.ell.cols.shape[-3]:
            y = ragged_ell_rows_ref(part.ell.cols, ell, part.ell.tile_col,
                                    part.ell.unit_k, bt, plan.ell, y,
                                    segments=tuple(meta.ell_segments))
        if chain is not None:
            chain.mark("ell")
        if part.coo.vals.shape[-1]:
            y = coo_rows_ref(part.coo.cols, coo, pad_b_to_tiles(b, meta),
                             plan.coo, y)
    if chain is not None:
        chain.mark("coo")
    return y


def normalise(y: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Each head's block of ``y`` [G, P, H * F'] over its row's
    denominator ``d`` [G, P, H]; 0 where the row has no neighbour (d =
    0), never 0 / 0."""
    g, p, h = d.shape
    y4 = y.reshape(g, p, h, -1)
    dd = d[..., None]
    return torch.where(dd > 0, y4 / dd, 0.0).reshape(g, p, -1)


def head_mean(y: torch.Tensor, h: int) -> torch.Tensor:
    """[G, P, H * F'] -> [G, P, F']: the heads added in order, then over
    H (elementwise, so a member's bits do not depend on the group)."""
    y4 = y.reshape(y.shape[0], y.shape[1], h, -1)
    acc = y4[:, :, 0]
    for k in range(1, h):
        acc = acc + y4[:, :, k]
    return acc / h


def gat_forward(part: TriPartition, x, weights, spec: GatSpec, *,
                meta: PartitionMeta, plan: ReductionPlan, rows: RowLists,
                backend: str = "cuda", device="cuda",
                chain=None) -> torch.Tensor:
    """The GAT's logits over a padded partition of the graph's pattern.

    ``x`` [(G,) N, F_in], ``weights`` the flat list of ``gat_weights``
    (each with an optional group axis), ``rows`` the group's
    ``RowLists`` on the device, ``plan`` its reduction plan. Returns
    [(G,) n_rows, spec.out_width] float32. ``chain`` (an
    ``obs.device.DeviceChain``) is marked per layer at ``xw``, ``attn``,
    ``dense``, ``ell``, ``coo`` and, but after the last layer, ``out``,
    which the caller marks once it has unpadded the logits. No
    gradients: inference only.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    if meta.n_row_tiles != meta.n_col_tiles:
        raise ValueError("GAT needs a square partition (A + I)")
    dev = resolve_device(device)
    part, h, plan, squeeze = _grouped(part, x, plan, meta, dev)
    h = pad_b_to_tiles(h, meta)
    p = meta.n_padded_rows
    n_layers = len(spec.heads)
    with torch.no_grad():
        for i in range(n_layers):
            heads = spec.heads[i]
            w, att = (as_operand(t).to(dev) for t in weights[2 * i:2 * i + 2])
            w = w if w.dim() == 3 else w[None]
            att = att if att.dim() == 3 else att[None]
            if chain is not None:
                chain.layer = i
            b = member_matmul(h, w)                               # [G, N, F]
            st = member_matmul(b, att)                            # [G, N, 2H]
            if chain is not None:
                chain.mark("xw")
            s = st[:, :p, :heads].contiguous()
            t = st[..., heads:].contiguous()
            if backend == "cuda":
                m, d = gat_coef.gat_row_stats(rows.offsets, rows.cols, s, t,
                                              NEGATIVE_SLOPE, device=dev)
                coef = gat_coef.gat_edge_coef(part, s, t, m, NEGATIVE_SLOPE,
                                              meta.tile, device=dev)
            else:
                m, d = gat_row_stats_ref(rows.offsets, rows.cols, s, t,
                                         NEGATIVE_SLOPE)
                coef = gat_edge_coef_ref(part, s, t, m, NEGATIVE_SLOPE,
                                         meta.tile)
            if chain is not None:
                chain.mark("attn")
            y = normalise(_aggregate(part, coef, b, meta, plan, backend,
                                     chain), d)
            if spec.elu[i]:
                y = torch.nn.functional.elu(y)
            if spec.skip[i]:
                y = y + h[:, :p]
            if not spec.concat[i]:
                y = head_mean(y, heads)
            if chain is not None and i < n_layers - 1:
                chain.mark("out")
            h = y
    h = h[:, :meta.n_rows]
    return h[0] if squeeze else h
