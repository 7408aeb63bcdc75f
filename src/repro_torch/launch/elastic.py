"""Elastic scaling: re-mesh a live training state when the rank pool
changes (port of ``repro.launch.elastic``).

Protocol at 1000+ nodes:
  1. the straggler/health watchdog (distributed.fault_tolerance) marks a
     host dead -> the job controller picks the largest good mesh shape,
  2. every param/opt leaf is resharded onto the new mesh with the same
     PartitionSpec rules (specs are mesh-shape-agnostic by construction:
     rules degrade to replication when a dim stops dividing evenly),
  3. the data stream re-seeds by step id, training resumes — no
     checkpoint round-trip needed when the state survives in host RAM;
     otherwise restore-from-latest (CheckpointManager) is the fallback.

The port's leaves are this rank's blocks (``sharding.shard_tree``), which
do not know their mesh, so ``reshard_to_mesh`` is told the mesh they
were cut for (``mesh=``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed import sharding as shd
from repro_torch.tree import flatten_with_path, tree_unflatten


def reshard_to_mesh(tree, new_mesh, spec_tree, *, mesh):
    """Reshard every leaf from ``mesh`` onto ``new_mesh`` with its
    PartitionSpec, replicating dims that no longer divide evenly.

    Bounces through host memory, as the reference does: every leaf is
    gathered whole (collective over ``mesh``: each of its ranks calls),
    then cut to this rank's block of ``new_mesh``. A rank that is not on
    ``new_mesh`` gets ``None``. The blocks are on the device their leaf
    was on."""
    full = shd.gather_tree(tree, spec_tree, mesh)
    rank = dist.get_rank()
    if not (new_mesh.mesh == rank).any():
        return None
    leaves = [leaf for _, leaf in flatten_with_path(full)]
    specs = [s for _, s in flatten_with_path(spec_tree)]
    moved = []
    for leaf, s in zip(leaves, specs):
        host = leaf.cpu()
        spec = shd.fit_spec(s, tuple(host.shape), new_mesh)
        block = host[shd.local_slice(spec, tuple(host.shape), new_mesh, rank)]
        moved.append(block.clone().to(leaf.device))
    return tree_unflatten(tree, moved)


def shrink_mesh(mesh, keep_ranks):
    """The largest (data, model) mesh over the surviving global ranks:
    ``model`` is the largest divisor of their count that is at most its
    square root, as the reference picks it. Collective over the whole
    world (``torch.distributed.new_group`` is): every rank of the world
    calls, the ranks left out too, with the same ``keep_ranks``; those
    ranks must not use the mesh."""
    ranks = [int(r) for r in keep_ranks]
    n = len(ranks)
    model = 1
    for m in range(int(np.sqrt(n)), 0, -1):
        if n % m == 0:
            model = m
            break
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(n // model, model)
    return DeviceMesh(mesh.device_type, grid, mesh_dim_names=("data",
                                                              "model"))

