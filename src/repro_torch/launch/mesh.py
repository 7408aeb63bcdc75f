"""Device meshes on ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimension
names are the reference's axis names (``"data"``, ``"model"``, and
``"pod"`` for the two-pod mesh). The process group must exist before a
mesh is made: the caller runs ``torch.distributed.init_process_group``
with its own address, world size and rank (nothing here reads a cluster
from the environment).

The sharding rules read a mesh only through ``mesh_shape`` and
``axis_names``, so an object with a ``.shape`` dict and ``.axis_names``
(a ``types.SimpleNamespace``, as the reference's rules accept) serves as
a mesh there too, with no process group.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The single-pod 16 x 16 (data, model) mesh, or the two-pod
    2 x 16 x 16 (pod, data, model) one; raises unless the world size is
    256 (512)."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_mesh(shape, axes, device_type)


def make_mesh(shape, axes, device_type="cuda"):
    """A mesh of ``shape`` named ``axes`` over the whole world, ranks laid
    out row-major (rank r at the coordinates ``np.unravel_index(r,
    shape)``). Collective: every rank calls it."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a {shape} mesh needs {int(np.prod(shape))} "
                         f"ranks; the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size}, for a ``DeviceMesh`` or a duck-typed mesh."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def data_axes(mesh) -> tuple:
    """All batch-parallel axes of a mesh ('pod' is outer data parallelism)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis(mesh):
    return "model" if "model" in axis_names(mesh) else None


def all_axes(mesh) -> tuple:
    return axis_names(mesh)


def axes_size(mesh, axes) -> int:
    """Ranks along ``axes`` (a name, a tuple of names, or None = 1)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in axes]))


def grid(mesh):
    """A ``DeviceMesh``'s global ranks as a host array of its shape (None
    for a duck-typed mesh), read outside any dispatch mode (under the
    dry-run's fake tensors too)."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        ranks = getattr(mesh, "mesh", None)
        return ranks.numpy() if isinstance(ranks, torch.Tensor) else None


def coordinates(mesh, rank: int) -> dict:
    """{axis name: index} of global ``rank`` on ``mesh``. A duck-typed
    mesh numbers its positions row-major (``rank`` is then a position)."""
    names = axis_names(mesh)
    ranks = grid(mesh)
    if ranks is not None:
        hit = np.argwhere(ranks == int(rank))
        if hit.shape[0] != 1:
            raise ValueError(f"rank {rank} is not on the mesh")
        return dict(zip(names, (int(i) for i in hit[0])))
    shape = mesh_shape(mesh)
    idx = np.unravel_index(int(rank), [shape[a] for a in names])
    return dict(zip(names, (int(i) for i in idx)))


def ring(mesh, axes) -> tuple:
    """(global ranks along ``axes``, this rank's index among them): the
    ranks that share this rank's coordinates off ``axes``, in the order
    of a dimension sharded over ``axes`` (the first axis major, as
    ``PartitionSpec((a, b))`` lays it out)."""
    names = axis_names(mesh)
    axes = tuple(axes)
    me = coordinates(mesh, dist.get_rank())
    sel = tuple(slice(None) if a in axes else me[a] for a in names)
    kept = [a for a in names if a in axes]
    sub = grid(mesh)[sel].transpose([kept.index(a) for a in axes])
    sub = sub.reshape(-1)
    sizes = [mesh_shape(mesh)[a] for a in axes]
    pos = int(np.ravel_multi_index([me[a] for a in axes], sizes))
    return [int(r) for r in sub], pos


def axes_group(mesh, axes):
    """The process group of the ranks along ``axes`` (a name or a tuple
    of names, in the mesh's order) that share this rank's other
    coordinates; a rank's index in it is its block's index along a
    dimension sharded over ``axes``. One axis: the mesh's own group for
    it; several: the mesh's flattened group over them (built once by the
    mesh, collectively: every rank of the mesh makes the same call)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    ordered = tuple(a for a in axis_names(mesh) if a in axes)
    if ordered != axes:
        raise ValueError(f"axes {axes} are not in the mesh's order "
                         f"{axis_names(mesh)}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():     # the mesh's own host tensors
        return mesh[ordered]._flatten().get_group()
