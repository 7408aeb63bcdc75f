"""PyTorch/CUDA port of the H-GCN reproduction (``repro``).

The package mirrors the JAX reference module by module. Host
preprocessing (reorder, Algorithms 1+2, shape-class padding) is numpy as
in the reference; the GCN forward runs in PyTorch, with the dense-tile
and ragged-ELL engines as hand-written CUDA kernels for Hopper (sm_90a).
Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""
from .device import pin_ieee_f32, resolve_device

__all__ = ["pin_ieee_f32", "resolve_device"]
