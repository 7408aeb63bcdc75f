"""Per-rank programs of ``tests/test_torch_serving_tp.py`` and of the
sampled-subgraph case of ``tests/test_torch_specs.py``.

Each runs in its own process (``repro_torch.launch.local.run_ranks``,
gloo on the CPU) and imports the port only, so that a rank starts
without JAX; results go back as numpy arrays. ``jobs`` runs several of
them in one spawn, in order (every rank runs the same list).
"""
import dataclasses

import torch

from repro_torch.convert import tree_from_numpy
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp
from repro_torch.launch.mesh import make_mesh
from repro_torch.tree import tree_leaves, tree_map

AXES = ("data", "model")
# f32 compute and an f32 cache: the sharded passes against the unsharded
# ones and the reference's within f32 tolerances
SERVE_KW = dict(q_chunk=8, k_chunk=8, compute_dtype=None)


def _np(t):
    return t.detach().cpu().numpy()


def moe_dict(mesh, cfg, moe):
    """The MoE dict a case passes: the cell builder's (``"ep"``: it must
    be expert-parallel on this mesh), the tensor-parallel one forced
    (``"tp"``), or None."""
    from repro_torch.launch.specs import make_moe_shardings

    if moe == "ep":
        ms = make_moe_shardings(cfg, mesh)
        assert "ep_mesh" in ms, ms
        return ms
    return shd.tp_expert_shardings(mesh) if moe == "tp" else None


def serve(cfg, params, tokens, n_dec: int, max_len: int, plan=None):
    """Prefill ``tokens[:, :-n_dec]`` then decode the last ``n_dec``
    tokens one at a time: (the prefill's last-position logits, its
    cache, each decode's logits, the last cache), tensors."""
    from repro_torch.models import transformer as T

    s = tokens.shape[1] - n_dec
    h, cache = T.prefill(params, tokens[:, :s], cfg, max_len=max_len,
                         cache_dtype=torch.float32, plan=plan, **SERVE_KW)
    logits = T.logits_fn(params, h[:, -1:], cfg, plan)
    first = {k: v.clone() for k, v in cache.items()}
    dec = []
    for i in range(n_dec):
        lg, cache = T.decode_step(params, cache, tokens[:, s + i:s + i + 1],
                                  cfg, compute_dtype=None, plan=plan)
        dec.append(lg)
    return logits, first, dec, cache


def serve_worker(rank, world, shape, cfg, moe, params, tokens, n_dec,
                 max_len):
    """The sharded prefill and decodes on a ``shape`` mesh under the
    serving plan ("tp_fsdp"), gathered to whole tensors: {"prefill":
    logits, "cache": the prefill's cache, "decode": [logits], "last":
    the last cache, "plan": (attention, ffn, moe, batch axes), "counts":
    the collectives}."""
    from repro_torch.distributed.tp import LMPlan

    mesh = make_mesh(shape, AXES, "cpu")
    scfg = dataclasses.replace(cfg, parallelism="tp_fsdp")
    plan = LMPlan(scfg, mesh, moe_dict(mesh, scfg, moe),
                  batch=tokens.shape[0])
    full = tree_from_numpy(params, "cpu")
    local = shd.shard_tree(full, shd.lm_param_specs(scfg, mesh, full), mesh)
    dp = plan.batch_axes or None
    tb = shd.shard_tree({"t": torch.from_numpy(tokens)},
                        {"t": shd.P(dp, None)}, mesh)["t"]
    tp.reset_counts()
    logits, first, dec, last = serve(scfg, local, tb, n_dec, max_len, plan)
    counts = dict(tp.COUNTS)
    lspec = shd.P(dp, None, None)
    out = shd.gather_tree({"prefill": logits, "cache": first, "decode": dec,
                           "last": last},
                          {"prefill": lspec, "cache": plan.cache,
                           "decode": [lspec] * n_dec, "last": plan.cache},
                          mesh)
    return dict(tree_map(_np, out), counts=counts,
                plan=(plan.attn, plan.ffn, plan.moe, plan.batch_axes))


def minibatch_worker(rank, world, shape, arch, cell, params, opt_state,
                     batch):
    """The sampled-subgraph cell's step on a ``shape`` mesh, each rank
    given its data group's block of the subgraphs: the loss and the
    first moment after the step (the gradient times ``1 - b1``)."""
    from repro_torch.launch.specs import build_gnn_cell

    mesh = make_mesh(shape, AXES, "cpu")
    prog = build_gnn_cell(arch, cell, mesh)
    tb = shd.shard_tree({k: torch.from_numpy(v) for k, v in batch.items()},
                        prog.in_specs[2], mesh)
    p = tree_from_numpy(params, "cpu")
    s = tree_from_numpy(opt_state, "cpu")
    _, state, aux = prog.fn(p, s, tb)
    return {"loss": float(aux["loss"]),
            "mu": [_np(v) for v in tree_leaves(state.mu)]}


def jobs(rank, world, todo):
    """[fn(rank, world, *args) for (fn name, args) in ``todo``]."""
    return [globals()[name](rank, world, *args) for name, args in todo]
