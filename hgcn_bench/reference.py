"""The plain reference of the served GCN, in PyTorch alone.

``logits = A_tilde · relu(A_tilde · X · W1) · W2``, the paper's 2-layer
vanilla GCN (H-GCN §V-A), computed from the benchmark's own CSR,
weights and features. It imports nothing of the program: the
comparison it serves holds the program's served logits to it.
``Reference`` is the ``reference`` of ``models/gcn.py``; ``round_tf32``,
``csr_tensor`` and ``logit_err`` serve every model module.

``precision="float64"`` is the reference: float64 sparse CSR products
and float64 dense products. ``precision="tf32"`` is the control: the
same graph and operands in float32, with every operand of every product
rounded to TF32 first (10 mantissa bits, round to nearest even, as the
tensor cores read float32 when TF32 is on) and float32 accumulation.
It is the one step below the float32 with TF32 off that the
configuration states, and the benchmark's limit has to fail it.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

PRECISIONS = ("float64", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (nearest even);
    infinities and NaNs pass through."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) >> 13) << 13
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def csr_tensor(indptr, indices, data, shape, device, dtype) -> torch.Tensor:
    """A torch sparse CSR tensor from host CSR arrays."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta state"
        return torch.sparse_csr_tensor(
            torch.as_tensor(np.asarray(indptr, np.int64), device=device),
            torch.as_tensor(np.asarray(indices, np.int64), device=device),
            torch.as_tensor(np.asarray(data), device=device).to(dtype),
            size=tuple(shape), check_invariants=False)


class Reference:
    """The reference forward over one graph, on ``device``.

    ``csr`` is any object with ``indptr``, ``indices``, ``data`` and
    ``shape`` (a scipy CSR matrix does). The graph is placed once per
    precision; ``logits(x, weights)`` runs the forward on features
    ``x`` [N, F] and weights [F, H], [H, C] (any float type; they are
    cast to the precision's type).
    """

    def __init__(self, csr, device, precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.precision = precision
        self.device = torch.device(device)
        dtype = torch.float64 if precision == "float64" else torch.float32
        self.dtype = dtype
        data = np.asarray(csr.data)
        if precision == "tf32":
            data = round_tf32(torch.as_tensor(data, dtype=torch.float32)
                              ).numpy()
        self.a = csr_tensor(csr.indptr, csr.indices, data, csr.shape,
                            self.device, dtype)

    def _op(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.device, self.dtype)
        return round_tf32(t) if self.precision == "tf32" else t

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        # dense X·W; with TF32 rounding of both operands, products are
        # exact in float32 and only the accumulation rounds
        with _ieee_matmul():
            return torch.matmul(self._op(x), self._op(w))

    def _spmm(self, b: torch.Tensor) -> torch.Tensor:
        return torch.sparse.mm(self.a, self._op(b))

    def logits(self, x: torch.Tensor, weights) -> torch.Tensor:
        h = x
        for i, w in enumerate(weights):
            h = self._spmm(self._mm(h, w))
            if i < len(weights) - 1:
                h = torch.relu(h)
        return h


class _ieee_matmul:
    """Keep cuBLAS from applying TF32 of its own inside the reference:
    the rounding is explicit, so both precisions mean the same on every
    device."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False


def logit_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The compared number: the largest absolute gap of a logit from the
    reference's, over the largest absolute reference logit (computed in
    float64). Non-finite output reads as infinity."""
    got = got.to(want.device, torch.float64)
    if got.shape != want.shape:
        return float("inf")
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    return gap / scale if scale > 0 else gap
