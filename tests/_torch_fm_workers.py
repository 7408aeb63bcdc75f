"""Per-rank programs of ``tests/test_torch_fm_sharded.py``.

Each runs in its own process (``repro_torch.launch.local.run_ranks``,
gloo on the CPU) and imports the port only, so that a rank starts
without JAX; results go back as numpy arrays, gathered whole on every
rank. ``jobs`` runs several cases in one spawn, in order.
"""
import dataclasses

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import tree_from_numpy
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.rows import FMShards, RowLookup
from repro_torch.launch import specs
from repro_torch.launch.mesh import all_axes, data_axes, make_mesh
from repro_torch.models import fm as fm_m
from repro_torch.models.common import take
from repro_torch.train import steps
from repro_torch.train.optimizer import AdamW
from repro_torch.tree import tree_map

AXES = ("data", "model")


class GradsOut:
    """An "optimizer" whose new parameters are the gradients it is given:
    the train step's gradients, after its reductions."""

    def update(self, grads, state, params):
        return grads, state


def cells(cfg, batch: int, n_cand: int, n_user: int):
    """The FM train, serve and retrieval cells of ``cfg`` at these
    sizes (``launch.specs.build_fm_cell``'s programs)."""
    arch = dataclasses.replace(get_arch("fm"), config=cfg)
    return {"train": ShapeCell("train", "rec_train", global_batch=batch),
            "serve": ShapeCell("serve", "rec_serve", global_batch=batch),
            "retrieval": ShapeCell("retrieval", "rec_retrieval",
                                   n_candidates=n_cand)}, arch


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def fm_case(rank, world, shape, cfg, params, batch, user, cand, n_user,
            n_steps):
    """The three cells' ``fn`` on this rank's blocks over a ``shape``
    mesh: ``n_steps`` train steps (losses, the parameters after them),
    the step's gradients at ``params`` (``GradsOut``), the serve scores,
    the retrieval scores, each gathered; the layout of the tables; and
    whether the row-sharded lookup of this rank's batch equals ``take``
    on the whole table, bit for bit."""
    mesh = make_mesh(shape, AXES, "cpu")
    shape_cells, arch = cells(cfg, batch["idx"].shape[0], cand.shape[0],
                              n_user)
    progs = {k: specs.build_fm_cell(arch, c, mesh)
             for k, c in shape_cells.items()}
    tr = progs["train"]
    p_specs, o_specs, b_specs = tr.in_specs
    rows = p_specs["v"][0] is not None
    full = tree_from_numpy(params, "cpu")
    p = shd.shard_tree(full, p_specs, mesh)
    s = shd.shard_tree(AdamW(lr=1e-3).init(full), o_specs, mesh)
    b = shd.shard_tree(tree_from_numpy(batch, "cpu"), b_specs, mesh)
    losses = []
    for _ in range(n_steps):
        p, s, aux = tr.fn(p, s, b)
        losses.append(float(aux["loss"]))
    out = {"rows": rows, "losses": losses,
           "params": _np(shd.gather_tree(p, p_specs, mesh))}

    p0 = shd.shard_tree(full, p_specs, mesh)
    grads, _, aux = steps.make_fm_train_step(
        cfg, GradsOut(), shards=FMShards(mesh, rows))(p0, None, b)
    out["grads"] = _np(shd.gather_tree(grads, p_specs, mesh))
    out["grad_loss"] = float(aux["loss"])

    dp = data_axes(mesh)
    sv = progs["serve"]
    idx = shd.shard_tree({"idx": torch.from_numpy(batch["idx"])},
                         sv.in_specs[1], mesh)
    scores = sv.fn(p0, idx)
    out["serve"] = _np(shd.gather_tree(scores, shd.P(dp), mesh))

    rt = progs["retrieval"]
    c_block = shd.shard_tree(torch.from_numpy(cand), rt.in_specs[2], mesh)
    got = rt.fn(p0, torch.from_numpy(user), c_block)
    out["retrieval"] = _np(shd.gather_tree(got, shd.P(all_axes(mesh)),
                                           mesh))
    if rows:
        flat = torch.from_numpy(batch["idx"]).long() + torch.as_tensor(
            fm_m.field_offsets(cfg)).long()[None, :]
        mine = shd.shard_tree(flat, shd.P(dp, None), mesh)
        with torch.no_grad():
            out["lookup_equal"] = bool(torch.equal(
                RowLookup(mesh, dp)(p0["v"], mine), take(full["v"], mine)))
    return out


def jobs(rank, world, todo):
    """Run each ``(name of a function here, args)`` of ``todo`` in
    order; their results, in order."""
    return [globals()[name](rank, world, *args) for name, args in todo]
