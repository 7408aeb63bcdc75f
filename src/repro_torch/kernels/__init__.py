"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Nothing here imports a compiler or builds anything at import time: the
CUDA sources under ``csrc/`` build at the first launch on a CUDA tensor.
"""
from . import ops, ref
from .bsr_spmm import bsr_spmm
from .ell_spmm import ell_spmm, ragged_ell_spmm
from .tile_matmul import tile_matmul

__all__ = ["ops", "ref", "bsr_spmm", "ell_spmm", "ragged_ell_spmm",
           "tile_matmul"]
