"""Carry state from the JAX reference into the port.

The reference's host preprocessing yields numpy arrays in its own
containers (``repro.core.formats.TriPartition``/``PartitionMeta``). These
helpers rewrap such state in the port's containers, so that the same
partition and weights can be run through both packages. They read the
reference's objects by field name and import nothing from it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import (CooResidual, DenseTiles, PartitionMeta,
                                      RaggedEll, TriPartition)
from repro_torch.device import resolve_device


def partition_from_numpy(part, meta) -> tuple:
    """(port TriPartition, port PartitionMeta) from a reference partition
    whose arrays are numpy. The arrays stay host numpy (what
    ``Engine.register(part_meta=...)`` takes; ``partition_to`` places
    them on a device)."""
    p = TriPartition(
        dense=DenseTiles(*(np.asarray(a) for a in part.dense)),
        ell=RaggedEll(*(np.asarray(a) for a in part.ell)),
        coo=CooResidual(*(np.asarray(a) for a in part.coo)),
    )
    m = PartitionMeta(**{f.name: getattr(meta, f.name)
                         for f in dataclasses.fields(PartitionMeta)})
    return p, m


def weights_from_numpy(weights, device="cuda") -> list:
    """The port's GCN weights: float32 tensors on ``device``."""
    dev = resolve_device(device)
    return [torch.from_numpy(np.array(w, np.float32)).to(dev)
            for w in weights]
