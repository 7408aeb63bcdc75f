"""Per-rank programs of ``tests/test_torch_distributed.py``.

Each runs in its own process (``repro_torch.launch.local.run_ranks``,
gloo on the CPU) and imports the port only, so that a rank starts
without JAX; results go back as numpy arrays. ``jobs`` runs several of
them in one spawn, in order (every rank runs the same list).
"""
import torch
import torch.distributed as dist

from repro_torch.distributed.halo import make_halo_ops
from repro_torch.distributed.sharding import (P, graph_batch_specs,
                                              local_slice, shard_tree)
from repro_torch.launch.elastic import reshard_to_mesh, shrink_mesh
from repro_torch.launch.mesh import all_axes, make_mesh


def _np(t):
    return t.detach().cpu().numpy()


def _halo(mesh, axes, x, idx, vals):
    """take, segment_sum and d/dx (take(x, idx)**2).sum() on this rank's
    blocks of x [n, d], idx [m], vals [m, d] (1-D sharded over axes)."""
    take, seg = make_halo_ops(mesh, axes)
    spec = P(axes, None)
    rank = dist.get_rank()
    xl = torch.from_numpy(x[local_slice(spec, x.shape, mesh, rank)])
    il = torch.from_numpy(idx[local_slice(spec, idx.shape, mesh, rank)])
    vl = torch.from_numpy(vals[local_slice(spec, vals.shape, mesh, rank)])
    got = take(xl, il)
    summed = seg(vl, il, xl.shape[0])
    xg = xl.clone().requires_grad_(True)
    (take(xg, il) ** 2).sum().backward()
    vg = vl.clone().requires_grad_(True)
    (seg(vg, il, xl.shape[0]) ** 2).sum().backward()
    return {"take": _np(got), "segment_sum": _np(summed),
            "take_grad": _np(xg.grad), "segment_sum_grad": _np(vg.grad)}


def halo_worker(rank, world, shape, cases):
    """The halo ops over every axis of a ``shape`` mesh, once per case
    (x, idx, vals)."""
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    return [_halo(mesh, all_axes(mesh), *c) for c in cases]


def moe_worker(rank, world, cfg, x, layer, ct):
    """``moe_ffn_ep`` on a (2, 4) mesh: this rank's data shard of x and
    model slice of the experts; the output, and the gradients of
    sum(out * ct) summed over the data group (dx: this rank's rows)."""
    from repro_torch.models.moe_ep import moe_ffn_ep

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    t = x.shape[0] // 2
    e_local = cfg.n_experts // 4
    p = {k: torch.from_numpy(v[m * e_local:(m + 1) * e_local]
                             if k.startswith("w_") else v).requires_grad_(True)
         for k, v in layer.items() if k in ("router", "w_gate", "w_up",
                                            "w_down")}
    xl = torch.from_numpy(x[d * t:(d + 1) * t]).requires_grad_(True)
    out = moe_ffn_ep(xl, p, cfg, mesh, dp_axes=("data",), mdl_axis="model")
    (out * torch.from_numpy(ct[d * t:(d + 1) * t])).sum().backward()
    grads = {}
    for k, v in p.items():
        g = v.grad.clone()
        dist.all_reduce(g, group=mesh.get_group("data"))
        grads[k] = _np(g)
    return {"coord": (d, m), "out": _np(out), "dx": _np(xl.grad),
            "grads": grads}


def elastic_worker(rank, world, full):
    """Leaves sharded on an (4, 2) mesh, resharded onto the shrunken
    meshes of ranks 0-3 (2 x 2) and of ranks 0-2 (3 x 1, where the
    first dimension no longer divides and is replicated)."""
    mesh8 = make_mesh((4, 2), ("data", "model"), "cpu")
    specs = {"w": P("data", "model"), "b": P(("data", "model"))}
    tree = {k: torch.from_numpy(v) for k, v in full.items()}
    local = shard_tree(tree, specs, mesh8)
    out = {}
    for keep in ((0, 1, 2, 3), (0, 1, 2)):
        mesh = shrink_mesh(mesh8, keep)
        moved = reshard_to_mesh(local, mesh, specs, mesh=mesh8)
        out[keep] = (None if moved is None else
                     {"shape": tuple(mesh.shape),
                      **{k: _np(v) for k, v in moved.items()}})
    return out


def gnn_worker(rank, world, shape, cfg, params, batch, steps, lr):
    """``steps`` AdamW steps of the halo-sharded GNN step on a ``shape``
    mesh over this rank's shard of the full-graph ``batch``; on one rank
    also the unsharded step in the same process, and whether the two
    agree bit for bit."""
    from repro_torch.convert import tree_from_numpy
    from repro_torch.models.gnn import default_gops
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.steps import make_gnn_train_step
    from repro_torch.tree import tree_leaves

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    full = {k: torch.from_numpy(v) for k, v in batch.items()}
    local = shard_tree(full, graph_batch_specs(mesh, full), mesh)

    def run(gops, b):
        opt = AdamW(lr=lr)
        p = tree_from_numpy(params, "cpu")
        state = opt.init(p)
        step = make_gnn_train_step(cfg, opt, gops=gops, remat=True)
        losses = []
        for _ in range(steps):
            p, state, aux = step(p, state, b)
            losses.append(aux["loss"])
        return losses, tree_leaves(p)

    losses, leaves = run(make_halo_ops(mesh, all_axes(mesh)), local)
    out = {"losses": [float(v) for v in losses],
           "params": [_np(v) for v in leaves]}
    if world == 1:
        ref_losses, ref_leaves = run(default_gops(), full)
        out["bitwise"] = (
            all(torch.equal(a, b) for a, b in zip(losses, ref_losses))
            and all(torch.equal(a, b) for a, b in zip(leaves, ref_leaves)))
    return out


def jobs(rank, world, todo):
    """{name: worker(rank, world, *args)} for each (name, args) of
    ``todo``, in order."""
    return {name: globals()[name](rank, world, *args) for name, args in todo}
