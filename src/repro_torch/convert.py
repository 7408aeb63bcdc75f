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
from repro_torch.train import optimizer


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


def tree_from_numpy(tree, device="cuda"):
    """A reference parameter or optimizer-state tree (leaves numpy, or
    anything ``np.asarray`` reads) as the port's: every leaf a tensor on
    ``device`` with the leaf's dtype; dicts, lists and tuples kept, and
    the reference's ``AdamWState``/``SGDState`` (read by type name and
    field) rebuilt as the port's. ``gcn_init``'s ``{"w": [...]}``, the
    GatedGCN and MeshGraphNet dicts, the ``dimenet_init`` and
    ``nequip_init`` trees (dicts, lists of blocks and layers, ``(w, b)``
    MLP tuples) and the optimizer states all carry over."""
    dev = resolve_device(device)
    states = {"AdamWState": optimizer.AdamWState,
              "SGDState": optimizer.SGDState}

    def carry(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: carry(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            cls = states.get(type(node).__name__)
            if cls is None or cls._fields != node._fields:
                raise TypeError(f"no port type for {type(node).__name__}")
            return cls(*(carry(getattr(node, f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(carry(v) for v in node)
        return torch.from_numpy(np.array(node)).to(dev)

    return carry(tree)


def weights_from_numpy(weights, device="cuda") -> list:
    """The port's GCN weights: float32 tensors on ``device``."""
    dev = resolve_device(device)
    return [torch.from_numpy(np.array(w, np.float32)).to(dev)
            for w in weights]
