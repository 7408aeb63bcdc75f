"""GAT (Velickovic et al., "Graph Attention Networks", ICLR 2018,
arXiv:1710.10903), its §3.3 inductive model: ``config["model"]["kind"]
== "gat"``.

The configuration's ``model.layers`` gives each layer's ``heads``,
``head_width`` (F'), ``concat`` (else the heads are averaged), ``elu``
and ``skip`` (the layer's input added after its activation), and
``negative_slope`` LeakyReLU's slope. Per head

    e_ij = LeakyReLU(a_l . W h_i + a_r . W h_j),
    alpha_ij = softmax over j in N(i) of e_ij   (N(i): row i of A + I),
    h_i' = sum_j alpha_ij W h_j.

The program serves it through ``Engine.register(..., model="gat",
weights=<the layers>)``. ``Reference`` below is the plain forward the
served logits are held to, in PyTorch alone; it imports nothing of the
program. Where both depart from the paper: the skip is h2 = ELU(GAT2(h1))
+ h1; no biases; the output is the classes' logits, without PPI's
sigmoid; a_l and a_r are glorot-initialised.
"""
from __future__ import annotations

import inspect
import math
import warnings

import numpy as np
import torch

from hgcn_bench import traffic as traffic_mod
from hgcn_bench.reference import PRECISIONS, _ieee_matmul, round_tf32

# LeakyReLU's negative slope, the paper's and the program's default
NEGATIVE_SLOPE = 0.2


def _uniform(gen, shape, lim, device):
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (2.0 * lim) - lim


def make_inputs(torch_, config: dict, traffic: dict, seed: int, n: int,
                device) -> tuple:
    """The layers' parameters and the feature pool, made on the device
    from the seed in a few large calls, float32, from one generator:
    each layer's W (glorot, [F_in, H * F']) and attention vector (glorot
    over its 2F' entries a head, [H, 2F'], split into a_l and a_r), then
    the pool. Returns (a list of one dict a layer with ``w``, ``a_l``,
    ``a_r``, ``concat``, ``elu``, ``skip``; the pool [snapshots, n,
    F_in])."""
    graph, model = config["graph"], config["model"]
    if float(model.get("negative_slope", NEGATIVE_SLOPE)) != NEGATIVE_SLOPE:
        raise ValueError(f"the program and the reference take LeakyReLU's "
                         f"slope {NEGATIVE_SLOPE}, the configuration states "
                         f"{model['negative_slope']}")
    gen = torch_.Generator(device=device)
    gen.manual_seed(int(seed))
    f_in = int(graph["n_features"])
    layers = []
    f = f_in
    for lay in model["layers"]:
        h, fh = int(lay["heads"]), int(lay["head_width"])
        w = _uniform(gen, (f, h * fh), math.sqrt(6.0 / (f + h * fh)), device)
        a = _uniform(gen, (h, 2 * fh), math.sqrt(6.0 / (2 * fh + 1)), device)
        layers.append({"w": w, "a_l": a[:, :fh].contiguous(),
                       "a_r": a[:, fh:].contiguous(),
                       "concat": bool(lay["concat"]), "elu": bool(lay["elu"]),
                       "skip": bool(lay["skip"])})
        f = h * fh if lay["concat"] else fh
    return layers, traffic_mod.feature_pool(torch_, gen, traffic, n, f_in,
                                            device)


def register(engine, name: str, csr, graph: dict, labels, weights):
    """``Engine.register`` with the graph block's reorder, the GAT's
    layers and ``model="gat"``; NotImplementedError at once where the
    program's ``register`` takes no model (a program that serves the GCN
    alone)."""
    if "model" not in inspect.signature(engine.register).parameters:
        raise NotImplementedError(
            "the program has no GAT: its Engine.register takes no "
            "model='gat'")
    return engine.register(name, csr, reorder=graph["reorder"],
                           labels=labels, weights=weights, model="gat")


class Reference:
    """The GAT forward over one graph's pattern, on ``device``.

    ``csr`` is any object with ``indptr``, ``indices`` and ``shape`` (a
    scipy CSR matrix of A + I; its values are not read). ``logits(x,
    layers)`` runs the forward on features ``x`` [N, F_in] and the layers
    of ``make_inputs``. ``precision="float64"``: float64 throughout, the
    reference. ``precision="tf32"``: the control, float32 with every
    operand of every product (X·W, the attention dot products, the
    aggregation's coefficients and B) rounded to TF32 first, float32
    sums. Per head the aggregation is one ``torch.sparse`` CSR product
    with the head's coefficients as values, over A + I's pattern.
    """

    def __init__(self, csr, device, precision: str = "float64",
                 slope: float = NEGATIVE_SLOPE):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" \
            else torch.float32
        self.device = torch.device(device)
        self.slope = slope
        self.indptr = torch.as_tensor(np.asarray(csr.indptr, np.int64),
                                      device=self.device)
        self.cols = torch.as_tensor(np.asarray(csr.indices, np.int64),
                                    device=self.device)
        self.n = int(csr.shape[0])
        self.rows = torch.arange(self.n, device=self.device).repeat_interleave(
            self.indptr.diff())

    def _op(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.device, self.dtype)
        return round_tf32(t) if self.precision == "tf32" else t

    def layer(self, h: torch.Tensor, lay: dict) -> torch.Tensor:
        n, rows, cols = self.n, self.rows, self.cols
        a_l, a_r = self._op(lay["a_l"]), self._op(lay["a_r"])
        heads, f = a_l.shape
        with _ieee_matmul():
            b = torch.matmul(self._op(h), self._op(lay["w"]))
        bh = self._op(b).reshape(n, heads, f)
        s = (bh * a_l).sum(-1)                                  # [N, H]
        t = (bh * a_r).sum(-1)
        e = torch.nn.functional.leaky_relu(s[rows] + t[cols], self.slope)
        m = torch.full((n, heads), -torch.inf, dtype=self.dtype,
                       device=self.device)
        m = m.scatter_reduce(0, rows[:, None].expand(-1, heads), e, "amax")
        p = torch.exp(e - m[rows])
        d = torch.zeros((n, heads), dtype=self.dtype, device=self.device)
        d = d.index_add(0, rows, p)
        alpha = self._op(p / d[rows])
        del e, p
        outs = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)    # "beta state"
            for k in range(heads):
                a = torch.sparse_csr_tensor(self.indptr, cols,
                                            alpha[:, k].contiguous(), (n, n),
                                            check_invariants=False)
                outs.append(torch.sparse.mm(a, bh[:, k].contiguous()))
        out = torch.stack(outs, dim=1)                          # [N, H, F']
        y = out.reshape(n, heads * f) if lay["concat"] else out.mean(1)
        if lay["elu"]:
            y = torch.nn.functional.elu(y)
        if lay["skip"]:
            y = y + h.to(self.dtype)
        return y

    def logits(self, x: torch.Tensor, layers) -> torch.Tensor:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        h = x.to(self.device, self.dtype)
        for lay in layers:
            h = self.layer(h, lay)
        return h


def reference(csr, device, precision: str = "float64") -> Reference:
    return Reference(csr, device, precision)


def request_flops(config: dict, n: int, nnz: int) -> float:
    """Model FLOPs of one full-graph GAT inference on the unpadded graph,
    a layer: X·W (2·N·F_in·H·F'), the attention scores a_l·Wh and a_r·Wh
    (4·N·H·F'), the edge softmax (5 a stored entry and head: the add,
    LeakyReLU, the subtraction, the exponential and the sum) and the
    aggregation (2·nnz·H·F')."""
    graph, model = config["graph"], config["model"]
    f = int(graph["n_features"])
    total = 0.0
    for lay in model["layers"]:
        h, fh = int(lay["heads"]), int(lay["head_width"])
        total += (2.0 * n * f * h * fh + 4.0 * n * h * fh + 5.0 * nnz * h
                  + 2.0 * nnz * h * fh)
        f = h * fh if lay["concat"] else fh
    return total
