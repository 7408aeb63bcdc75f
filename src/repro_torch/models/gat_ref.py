"""The plain reference of the served GAT: the forward in plain ``torch``
ops, with no port kernel, no partition and no batching.

GAT, Velickovic et al., "Graph Attention Networks", ICLR 2018,
arXiv:1710.10903, as its §3.3 inductive (PPI) model: layers 1 and 2 of
K = 4 heads x F' = 256 features concatenated (1024) and ELU; a skip
connection across layer 2; layer 3 of K = 6 heads x C features
averaged. Per head

    e_ij = LeakyReLU_0.2(a_l . W h_i + a_r . W h_j),
    alpha_ij = softmax over j in N(i) (A + I's row i) of e_ij,
    h_i' = sum_j alpha_ij W h_j.

Where this forward departs from the paper (the served one departs in
the same places):

  * the skip is placed as h2 = ELU(GAT2(h1)) + h1, read from "skip
    connections across the intermediate attentional layer";
  * no biases;
  * the output is C classes as logits, without PPI's sigmoid;
  * a_l and a_r are glorot-initialised (the caller's weights).

``layers`` is a list of ``core.gat.GatLayer`` (or any object with the
fields ``w``, ``a_l``, ``a_r``, ``concat``, ``elu``, ``skip``); the graph
is ``indptr`` / ``indices`` of A + I in CSR (its values are not read:
the pattern is the graph). Float32 by default, float64 where asked;
TF32 is switched off first.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch


def _edges(indptr, indices, device) -> tuple:
    indptr = torch.as_tensor(np.asarray(indptr, np.int64), device=device)
    cols = torch.as_tensor(np.asarray(indices, np.int64), device=device)
    n = indptr.shape[0] - 1
    rows = torch.arange(n, device=device).repeat_interleave(indptr.diff())
    return indptr, rows, cols, n


def gat_layer(indptr, rows, cols, n, h, lay, slope, dtype):
    """One layer: ``h`` [N, F_in] -> [N, H*F'] (concat) or [N, F']."""
    w = torch.as_tensor(lay.w).to(h.device, dtype)
    a_l = torch.as_tensor(lay.a_l).to(h.device, dtype)
    a_r = torch.as_tensor(lay.a_r).to(h.device, dtype)
    heads, f = a_l.shape
    b = (h @ w).reshape(n, heads, f)
    s = (b * a_l).sum(-1)                                  # [N, H]
    t = (b * a_r).sum(-1)
    e = torch.nn.functional.leaky_relu(s[rows] + t[cols], slope)  # [E, H]
    m = torch.full((n, heads), -torch.inf, dtype=dtype, device=h.device)
    m = m.scatter_reduce(0, rows[:, None].expand(-1, heads), e, "amax")
    p = torch.exp(e - m[rows])
    d = torch.zeros((n, heads), dtype=dtype, device=h.device)
    d = d.index_add(0, rows, p)
    alpha = p / d[rows]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)       # "beta state"
        out = torch.stack([
            torch.sparse_csr_tensor(indptr, cols, alpha[:, k], (n, n),
                                    check_invariants=False)
            @ b[:, k] for k in range(heads)], dim=1)       # [N, H, F']
    y = out.reshape(n, heads * f) if lay.concat else out.mean(1)
    if lay.elu:
        y = torch.nn.functional.elu(y)
    if lay.skip:
        y = y + h
    return y


def gat_forward_ref(indptr, indices, x, layers, *, slope: float = 0.2,
                    dtype=torch.float32) -> torch.Tensor:
    """The GAT's logits [N, C] over A + I (CSR ``indptr``/``indices``)
    for features ``x`` [N, F_in], on ``x``'s device, in ``dtype``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.as_tensor(x)
    indptr, rows, cols, n = _edges(indptr, indices, x.device)
    h = x.to(dtype)
    for lay in layers:
        h = gat_layer(indptr, rows, cols, n, h, lay, slope, dtype)
    return h
