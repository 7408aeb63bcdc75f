"""Minimal real-basis SO(3) machinery for NequIP, no e3nn dependency
(port of ``repro.models.so3``).

Provides real spherical harmonics (l <= 2 explicit) and real-basis
Clebsch-Gordan coupling tensors computed from the Racah formula + the
complex->real change of basis. The coupling tensors are host numpy
(``real_cg``, computed once per path); ``cg_tensor`` places each one on
a device once per (path, device, dtype), so a forward builds none.

Conventions: real harmonics indexed m = -l..l; l=1 order is (y, z, x)
(e3nn convention), so D^1(R) = P R P^T with P the (x,y,z)->(y,z,x)
permutation.
"""
from __future__ import annotations

import functools
from math import factorial, sqrt

import numpy as np
import torch


# --------------------------------------------------- complex-basis CG ------
def _cg_complex(l1: int, m1: int, l2: int, m2: int, l3: int, m3: int) -> float:
    """<l1 m1 l2 m2 | l3 m3> via the Racah formula (exact for small l)."""
    if m3 != m1 + m2 or not abs(l1 - l2) <= l3 <= l1 + l2:
        return 0.0
    if abs(m1) > l1 or abs(m2) > l2 or abs(m3) > l3:
        return 0.0
    f = factorial
    pre = sqrt((2 * l3 + 1) * f(l3 + l1 - l2) * f(l3 - l1 + l2)
               * f(l1 + l2 - l3) / f(l1 + l2 + l3 + 1))
    pre *= sqrt(f(l3 + m3) * f(l3 - m3) * f(l1 - m1) * f(l1 + m1)
                * f(l2 - m2) * f(l2 + m2))
    s = 0.0
    for k in range(0, l1 + l2 - l3 + 1):
        denoms = (k, l1 + l2 - l3 - k, l1 - m1 - k, l2 + m2 - k,
                  l3 - l2 + m1 + k, l3 - l1 - m2 + k)
        if any(d < 0 for d in denoms):
            continue
        s += (-1) ** k / np.prod([float(f(d)) for d in denoms])
    return pre * s


def _real_basis_matrix(l: int) -> np.ndarray:
    """U[l] with  Y^real_m = sum_mu U[m, mu] Y^complex_mu  (rows m=-l..l)."""
    dim = 2 * l + 1
    u = np.zeros((dim, dim), complex)
    for m in range(-l, l + 1):
        i = m + l
        if m == 0:
            u[i, l] = 1.0
        elif m > 0:
            u[i, m + l] = (-1) ** m / sqrt(2)
            u[i, -m + l] = 1 / sqrt(2)
        else:  # m < 0 (sin-type)
            u[i, -m + l] = -1j * (-1) ** m / sqrt(2)
            u[i, m + l] = 1j / sqrt(2)
    return u


@functools.lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor C[m1, m2, m3], shape (2l1+1, 2l2+1, 2l3+1).

    Intertwiner property: C contracted with D^l1 x D^l2 on the first two
    indices equals D^l3 applied on the third.
    """
    c = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    cc = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1), complex)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                cc[m1 + l1, m2 + l2, m3 + l3] = _cg_complex(
                    l1, m1, l2, m2, l3, m3)
    u1, u2, u3 = (_real_basis_matrix(l) for l in (l1, l2, l3))
    creal = np.einsum("am,bn,co,mno->abc", u1, u2, np.conj(u3), cc)
    # for (l1+l2+l3) odd the real-basis tensor is purely imaginary
    if np.abs(creal.real).max() >= np.abs(creal.imag).max():
        c = creal.real
    else:
        c = creal.imag
    return np.ascontiguousarray(c)


@functools.lru_cache(maxsize=None)
def cg_tensor(l1: int, l2: int, l3: int, device: str,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``real_cg(l1, l2, l3)`` as a constant tensor on ``device`` (a
    string, e.g. ``"cuda:0"``), built once per path, device and dtype.
    Callers must not write to it."""
    return torch.as_tensor(real_cg(l1, l2, l3), dtype=dtype, device=device)


# ------------------------------------------------ real spherical harmonics -
def spherical_harmonics(vec: torch.Tensor, l_max: int) -> dict:
    """Real SH of unit(vec) for l=0..l_max (l_max <= 2), dict l -> [..., 2l+1].

    Normalized on the unit sphere; order m=-l..l with l=1 = (y, z, x).
    """
    n = vec / (torch.linalg.vector_norm(vec, dim=-1, keepdim=True) + 1e-12)
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    out = {0: torch.full(vec.shape[:-1] + (1,), sqrt(1 / (4 * np.pi)),
                         dtype=vec.dtype, device=vec.device)}
    if l_max >= 1:
        c1 = sqrt(3 / (4 * np.pi))
        out[1] = c1 * torch.stack([y, z, x], dim=-1)
    if l_max >= 2:
        c2a = 0.5 * sqrt(15 / np.pi)
        c2b = 0.25 * sqrt(5 / np.pi)
        c2c = 0.25 * sqrt(15 / np.pi)
        out[2] = torch.stack([
            c2a * x * y,
            c2a * y * z,
            c2b * (3 * z ** 2 - 1),
            c2a * x * z,
            c2c * (x ** 2 - y ** 2),
        ], dim=-1)
    if l_max >= 3:
        raise NotImplementedError("l_max <= 2")
    return out


def wigner_d_from_rotation(rot: np.ndarray, l: int) -> np.ndarray:
    """D^l(R) in the real basis, built recursively from D^1 via real CG
    (used by the equivariance tests)."""
    p = np.zeros((3, 3))
    p[0, 1] = p[1, 2] = p[2, 0] = 1.0       # (x,y,z) -> (y,z,x)
    d1 = p @ rot @ p.T
    if l == 0:
        return np.ones((1, 1))
    if l == 1:
        return d1
    d_prev = wigner_d_from_rotation(rot, l - 1)
    c = real_cg(1, l - 1, l)                 # [3, 2l-1, 2l+1]
    # D^l = C^T (D^1 x D^{l-1}) C  normalized by C^T C
    m = np.einsum("abc,ax,by,xyd->cd", c, d1, d_prev, c)
    norm = np.einsum("abc,abd->cd", c, c)
    return np.linalg.solve(norm, m)
