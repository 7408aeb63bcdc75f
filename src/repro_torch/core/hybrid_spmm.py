"""The tri-engine heterogeneous SpMM executor (paper §IV-A/§IV-D/§IV-E).

Port of ``repro.core.hybrid_spmm``. Computes ``Y = A @ B`` where A is a
TriPartition, dispatching each component to its engine:

  dense tiles -> per-tile T×T products, summed over tile_row
  ELL units   -> gather + FMA over the ragged unit array
                 (``ell_dispatch="ragged"``), or per fixed-K bucket
                 (``"fused"``/``"loop"``, the per-K A/B dispatches)
  COO residual-> take + segment sum        (flexible engine)

Two backends:
  * ``torch`` — plain PyTorch (mirrors the reference's ``xla``).
  * ``cuda``  — dense tiles and ELL units through the hand-written CUDA
                kernels in ``repro_torch.kernels`` (mirrors ``pallas``);
                on CPU tensors the kernel wrappers run their plain
                versions.

Every function accepts a leading group axis ``G`` on B and on all
partition leaves (the ``serve_group`` path), and a ``ReductionPlan``
(``repro_torch.core.formats.reduction_plan``) that fixes the order of
every sum onto output rows; without one, the plan is built on the fly
from the partition on the host.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (bsr_spmm_ref, ell_spmm_ref,
                                     ragged_ell_spmm_ref)

from .formats import (PartitionMeta, ReductionPlan, TriPartition, b_tiles_of,
                      ell_buckets, pad_b_to_tiles, partition_to, plan_to,
                      reduction_plan, segment_sum)

BACKENDS = ("cuda", "torch")


def dense_tiles_matmul(part: TriPartition, b: torch.Tensor,
                       meta: PartitionMeta, plan: ReductionPlan
                       ) -> torch.Tensor:
    """Dense-engine partial product, B [G, N, F] -> [G, nrt*T, F]."""
    g, _, f = b.shape
    T, nrt = meta.tile, meta.n_row_tiles
    n_t = part.dense.tiles.shape[-3]
    if n_t == 0:
        return b.new_zeros((g, nrt * T, f))
    prod = bsr_spmm_ref(part.dense.tiles, part.dense.tile_col,
                        b_tiles_of(b, meta))                 # [G,n_t,T,F]
    out = segment_sum(prod.reshape(g * n_t, T * f), plan.dense)
    return out.reshape(g, nrt * T, f)


def ell_matmul(part: TriPartition, b: torch.Tensor, meta: PartitionMeta,
               plan: ReductionPlan, *, dispatch: str = "ragged"
               ) -> torch.Tensor:
    """Sparse-engine partial product, [G, n_padded_rows, F].

    ``"ragged"`` runs one masked Kmax pass over the concatenated unit
    array; ``"fused"``/``"loop"`` run one fixed-K pass per bucket of
    ``meta.ell_segments`` and reduce the products at once ("fused") or
    bucket by bucket ("loop"), as ``repro_torch.kernels.ops.ell_matmul``
    does with the kernels.
    """
    kops.check_ell_dispatch(dispatch)
    g, _, f = b.shape
    if part.ell.cols.shape[-3] == 0:
        return b.new_zeros((g, meta.n_padded_rows, f))
    bt = b_tiles_of(b, meta)
    if dispatch == "ragged":
        prod = ragged_ell_spmm_ref(part.ell.cols, part.ell.vals,
                                   part.ell.tile_col, part.ell.unit_k, bt)
    else:
        prod = torch.cat([ell_spmm_ref(bk.cols, bk.vals, bk.tile_col, bt)
                          for bk in ell_buckets(part.ell, meta.ell_segments)],
                         dim=1)
    return kops.reduce_ell(part, prod, meta, plan, dispatch)


def coo_matmul(part: TriPartition, b: torch.Tensor, meta: PartitionMeta,
               plan: ReductionPlan) -> torch.Tensor:
    """Flexible-engine partial product (row-wise product SpMM),
    [G, nrt*T, F]."""
    g, _, f = b.shape
    nnz = part.coo.vals.shape[-1]
    if nnz == 0:
        return b.new_zeros((g, meta.n_padded_rows, f))
    bp = pad_b_to_tiles(b, meta)
    idx = part.coo.cols.long()[..., None].expand(g, nnz, f)
    msgs = part.coo.vals[..., None] * torch.gather(bp, 1, idx)  # [G,nnz,F]
    out = segment_sum(msgs.reshape(g * nnz, f), plan.coo)
    return out.reshape(g, meta.n_padded_rows, f)


def _grouped(part: TriPartition, b, plan, meta, dev, ell_dispatch):
    """Place everything on ``dev`` and give it a leading group axis.

    Returns (part, b, plan, squeeze): ``squeeze`` says the caller passed
    one unstacked graph, whose result drops the group axis again.
    """
    part = partition_to(part, dev)
    b = torch.as_tensor(b, dtype=torch.float32).to(dev)
    if plan is None:
        plan = reduction_plan(part, meta, loop=ell_dispatch == "loop")
    plan = plan_to(plan, dev)
    squeeze = b.dim() == 2
    if squeeze:
        part = TriPartition(*(type(c)(*(a[None] for a in c)) for c in part))
        b = b[None]
    return part, b, plan, squeeze


def hybrid_spmm(part: TriPartition, b, *, meta: PartitionMeta,
                backend: str = "cuda", ell_dispatch: str = "ragged",
                plan: ReductionPlan = None, device="cuda") -> torch.Tensor:
    """Y = A @ B via the three engines. Returns [(G,) n_rows, F] on
    ``device``."""
    dev = resolve_device(device)
    part, b, plan, squeeze = _grouped(part, b, plan, meta, dev,
                                      ell_dispatch)
    y = _hybrid(part, b, meta, plan, backend, ell_dispatch)
    return y[0] if squeeze else y


def _hybrid(part, b, meta, plan, backend, ell_dispatch):
    if backend == "cuda":
        yd = kops.dense_tiles_matmul(part, b, meta, plan)
        ye = kops.ell_matmul(part, b, meta, plan, dispatch=ell_dispatch)
    elif backend == "torch":
        yd = dense_tiles_matmul(part, b, meta, plan)
        ye = ell_matmul(part, b, meta, plan, dispatch=ell_dispatch)
    else:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    yc = coo_matmul(part, b, meta, plan)
    y = yd + ye + yc
    return y[:, : meta.n_rows]


# ---------------------------------------------------------------------------
# Combination-first chained SpMM with intra-layer pipelining (paper §IV-E).
# ---------------------------------------------------------------------------

def _layer(part, x, w, meta, plan, backend, block_cols, activation,
           ell_dispatch):
    """One GCN layer on grouped tensors: x [G, N, F_in], w [G, F_in, H]."""
    h = w.shape[-1]
    if block_cols and block_cols < h:
        nblk = -(-h // block_cols)
        wp = torch.nn.functional.pad(w, (0, nblk * block_cols - h))
        outs = [_hybrid(part, torch.matmul(
                    x, wp[..., i * block_cols:(i + 1) * block_cols]),
                    meta, plan, backend, ell_dispatch)
                for i in range(nblk)]
        y = torch.cat(outs, dim=-1)[..., :h]
    else:
        y = _hybrid(part, torch.matmul(x, w), meta, plan, backend,
                    ell_dispatch)
    return activation(y) if activation is not None else y


def gcn_layer(part: TriPartition, x, w, *, meta: PartitionMeta,
              backend: str = "cuda", block_cols: int = 0, activation=None,
              ell_dispatch: str = "ragged", plan: ReductionPlan = None,
              device="cuda") -> torch.Tensor:
    """One GCN layer  sigma(A @ (X @ W))  in combination-first order.

    ``block_cols > 0`` processes W's output columns in blocks, emitting
    ``A @ (X @ W[:, blk])`` per block (the paper's fine-grained
    pipelining). X·W is a plain ``torch.matmul``, as the reference
    leaves it to XLA.
    """
    dev = resolve_device(device)
    part, x, plan, squeeze = _grouped(part, x, plan, meta, dev,
                                      ell_dispatch)
    w = torch.as_tensor(w, dtype=torch.float32).to(dev)
    y = _layer(part, x, w if w.dim() == 3 else w[None], meta, plan, backend,
               block_cols, activation, ell_dispatch)
    return y[0] if squeeze else y


def gcn_forward(part: TriPartition, x, weights, *, meta: PartitionMeta,
                backend: str = "cuda", block_cols: int = 0,
                ell_dispatch: str = "ragged", plan: ReductionPlan = None,
                device="cuda") -> torch.Tensor:
    """The paper's 2-layer vanilla GCN:  softmax-free inference logits
    X2 = A·relu(A·X·W1)·W2   (activation on hidden layer only).

    With a leading group axis on ``x``, the partition leaves and the
    weights, the whole group runs with one launch of each kernel per
    layer.
    """
    dev = resolve_device(device)
    part, h, plan, squeeze = _grouped(part, x, plan, meta, dev,
                                      ell_dispatch)
    for i, w in enumerate(weights):
        w = torch.as_tensor(w, dtype=torch.float32).to(dev)
        act = torch.relu if i < len(weights) - 1 else None
        h = _layer(part, h, w if w.dim() == 3 else w[None], meta, plan,
                   backend, block_cols, act, ell_dispatch)
    return h[0] if squeeze else h
