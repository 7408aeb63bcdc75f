"""Per-rank programs of ``tests/test_torch_tp.py``.

Each runs in its own process (``repro_torch.launch.local.run_ranks``,
gloo on the CPU) and imports the port only, so that a rank starts
without JAX; results go back as numpy arrays. ``jobs`` runs several of
them in one spawn, in order (every rank runs the same list).
"""
import torch

from repro_torch.convert import tree_from_numpy
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp
from repro_torch.launch.mesh import all_axes, data_axes, make_mesh
from repro_torch.tree import tree_leaves, tree_map

AXES = ("data", "model")
LM_KW = dict(q_chunk=8, k_chunk=8, xent_chunk=8, compute_dtype=None)


def _np(t):
    return t.detach().cpu().numpy()


def lm_batch_specs(mesh, cfg):
    """The batch's layout under the config's ``parallelism``: over the
    data axes ("tp_fsdp"), over every axis ("fsdp")."""
    ax = all_axes(mesh) if cfg.parallelism == "fsdp" else data_axes(mesh)
    return {"tokens": shd.P(ax, None), "labels": shd.P(ax, None)}


def residual(mesh, cfg):
    """The reference's ``act_constraint`` for ``cfg`` on ``mesh``."""
    return shd.NamedSharding(mesh, tp.residual_spec(cfg, mesh))


def placed(mesh, cfg, params, batch):
    """(this rank's parameter blocks, batch blocks, parameter specs)."""
    full = tree_from_numpy(params, "cpu")
    specs = shd.lm_param_specs(cfg, mesh, full)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return (shd.shard_tree(full, specs, mesh),
            shd.shard_tree(tb, lm_batch_specs(mesh, cfg), mesh), specs)


def lm_worker(rank, world, shape, cfg, moe, params, batch):
    """The sharded LM loss and its gradients (gathered) on a ``shape``
    mesh; ``moe`` "tp" passes the tensor-parallel MoE dict."""
    from repro_torch.train.steps import make_lm_value_and_grad

    mesh = make_mesh(shape, AXES, "cpu")
    local, lb, specs = placed(mesh, cfg, params, batch)
    ms = shd.tp_expert_shardings(mesh) if moe == "tp" else None
    fn = make_lm_value_and_grad(cfg, act_constraint=residual(mesh, cfg),
                                moe_shardings=ms, **LM_KW)
    tp.reset_counts()
    loss, grads = fn(local, lb)
    counts = dict(tp.COUNTS)
    full = shd.gather_tree(grads, specs, mesh)
    return {"loss": float(loss), "grads": [_np(g) for g in
                                           tree_leaves(full)],
            "plan": (fn.plan.attn, fn.plan.ffn, fn.plan.moe, fn.plan.head),
            "counts": counts, "predicted": fn.plan.predicted_counts(
                batch["tokens"].shape[1], LM_KW["xent_chunk"])}


def forward_worker(rank, world, shape, cfg, params, tokens):
    """``transformer.forward`` with only an ``act_constraint`` (the
    reference's ``P(dp, model, None)``): this rank's block of the normed
    hidden, gathered over the mesh."""
    from repro_torch.models.transformer import forward

    mesh = make_mesh(shape, AXES, "cpu")
    full = tree_from_numpy(params, "cpu")
    local = shd.shard_tree(full, shd.lm_param_specs(cfg, mesh, full), mesh)
    act = shd.P(data_axes(mesh), "model", None)
    tl = shd.shard_tree({"t": torch.from_numpy(tokens)},
                        {"t": shd.P(data_axes(mesh), None)}, mesh)["t"]
    h = forward(local, tl, cfg, act_constraint=shd.NamedSharding(mesh, act),
                compute_dtype=None, q_chunk=8, k_chunk=8)
    return _np(shd.gather_tree({"h": h}, {"h": act}, mesh)["h"])


def clip_worker(rank, world, shape, cfg, params, batch, opt):
    """One clipped AdamW step (``opt``) of the sharded train step: the
    loss, the global norm of the gradients (``LMPlan.norm_reduce``) and
    the first moment after the step (the clipped gradient times
    ``1 - b1``), gathered."""
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.steps import make_lm_train_step

    mesh = make_mesh(shape, AXES, "cpu")
    local, lb, specs = placed(mesh, cfg, params, batch)
    plan = tp.LMPlan(cfg, mesh)
    norms = []

    def seen(g):
        norms.append(global_norm(g, plan.norm_reduce(g)))
        return g
    train = make_lm_train_step(cfg, opt, act_constraint=residual(mesh, cfg),
                               compress=seen, **LM_KW)
    _, state, aux = train(local, opt.init(local), lb)
    mu = shd.gather_tree(state.mu, specs, mesh)
    return {"loss": float(aux["loss"]), "norm": float(norms[0]),
            "mu": [_np(v) for v in tree_leaves(mu)]}


def whole_tensor_tp_worker(rank, world, shape, cfg, params, tokens):
    """``forward`` without an ``act_constraint``, ``prefill`` and
    ``decode_step`` given the tensor-parallel MoE dict over a ``shape``
    mesh: the (exception type, message) each raises."""
    from repro_torch.models import transformer as T

    mesh = make_mesh(shape, AXES, "cpu")
    ms = shd.tp_expert_shardings(mesh)
    p = tree_from_numpy(params, "cpu")
    t = torch.from_numpy(tokens)
    cache = T.init_cache(cfg, t.shape[0], t.shape[1], device="cpu")
    calls = {
        "forward": lambda: T.forward(p, t, cfg, compute_dtype=None,
                                     moe_shardings=ms),
        "prefill": lambda: T.prefill(p, t, cfg, max_len=t.shape[1],
                                     compute_dtype=None, moe_shardings=ms),
        "decode_step": lambda: T.decode_step(p, cache, t[:, :1], cfg,
                                             compute_dtype=None,
                                             moe_shardings=ms)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = (None, "")
        except Exception as e:  # noqa: BLE001 -- the test reads the type
            out[name] = (type(e).__name__, str(e))
    return out


def energy_worker(rank, world, cfg, params, batch, steps, lr):
    """``steps`` AdamW steps of the halo-sharded energy step over every
    axis of a (2, 2) mesh: the losses, the first step's gradients and the
    parameters after."""
    from repro_torch.distributed.halo import make_halo_ops
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.steps import make_gnn_train_step

    mesh = make_mesh((2, 2), AXES, "cpu")
    full = {k: torch.from_numpy(v) for k, v in batch.items()}
    local = shd.shard_tree(full, shd.graph_batch_specs(mesh, full), mesh)
    seen = []
    opt = AdamW(lr=lr)
    step = make_gnn_train_step(cfg, opt, gops=make_halo_ops(mesh,
                                                            all_axes(mesh)),
                               compress=lambda g: seen.append(g) or g)
    p = tree_from_numpy(params, "cpu")
    s = opt.init(p)
    losses = []
    for _ in range(steps):
        p, s, aux = step(p, s, local)
        losses.append(float(aux["loss"]))
    return {"losses": losses, "grads": [_np(g) for g in tree_leaves(seen[0])],
            "params": [_np(v) for v in tree_leaves(p)]}


def jobs(rank, world, todo):
    """[worker(rank, world, *args) for (name, args) in ``todo``], in
    order."""
    return [globals()[name](rank, world, *args) for name, args in todo]


def relayout_worker(rank, world, shape, x, ct, cases):
    """``with_sharding_constraint`` from each ``src`` block of ``x`` to
    ``dst`` on a ``shape`` mesh: the block it gives and the gradient of
    sum(out * ct's ``dst`` block)."""
    mesh = make_mesh(shape, AXES, "cpu")
    out = []
    for src, dst in cases:
        src, dst = shd.P(*src), shd.P(*dst)
        xs = torch.from_numpy(x[shd.local_slice(src, x.shape, mesh, rank)])
        xs.requires_grad_(True)
        y = shd.with_sharding_constraint(xs, shd.NamedSharding(mesh, dst),
                                         src)
        c = torch.from_numpy(ct[shd.local_slice(dst, ct.shape, mesh, rank)])
        (y * c).sum().backward()
        out.append({"y": _np(y), "grad": _np(xs.grad)})
    return out


def ep_fsdp_worker(rank, world, cfg, x, layer, ct):
    """``moe_ffn_ep`` on a (2, 2) mesh with this rank's experts whole and
    with their second dimension also split over `data` (ZeRO-3): the
    outputs, and the gradients of sum(out * ct) of the whole stacks
    summed over `data` next to the sharded stacks' (whose gather's
    reduce-scatter sums them), each cut to this rank's block."""
    import torch.distributed as dist

    from repro_torch.models.moe_ep import moe_ffn_ep

    mesh = make_mesh((2, 2), AXES, "cpu")
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    t = x.shape[0] // 2
    e_local = cfg.n_experts // 2
    xl = torch.from_numpy(x[d * t:(d + 1) * t])
    out = {}
    for name in ("whole", "fsdp"):
        p = {}
        for k, v in layer.items():
            if k.startswith("w_"):
                v = v[m * e_local:(m + 1) * e_local]
                if name == "fsdp":
                    n = v.shape[1] // 2
                    v = v[:, d * n:(d + 1) * n]
            p[k] = torch.from_numpy(v.copy()).requires_grad_(True)
        y = moe_ffn_ep(xl, p, cfg, mesh, dp_axes=("data",),
                       mdl_axis="model")
        (y * torch.from_numpy(ct[d * t:(d + 1) * t])).sum().backward()
        grads = {}
        for k, v in p.items():
            g = v.grad.clone()
            if k.startswith("w_") and name == "whole":
                dist.all_reduce(g, group=mesh.get_group("data"))
                n = g.shape[1] // 2
                g = g[:, d * n:(d + 1) * n]
            grads[k] = _np(g)
        out[name] = {"y": _np(y), "grads": grads}
    return out


def moe_window_worker(rank, world, shape, cfg, layer, x, ct):
    """``transformer.moe_ffn``'s tensor-parallel branch on a ``shape``
    mesh, the tokens ``x`` split over `data`, the experts' d_ff over
    `model`: this rank's outputs; the gradient of sum(out * ct) for its
    tokens and, summed over `data`, for the router and its block of the
    expert stacks; the shape of the slot weights the experts ran over
    ([E, window]); the capacity; and which of its (token, k)
    assignments kept a slot."""
    import math

    import numpy as np
    import torch.distributed as dist

    from repro_torch.models import transformer as T

    mesh = make_mesh(shape, AXES, "cpu")
    ms = shd.tp_expert_shardings(mesh)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    t, f = x.shape[0] // shape[0], cfg.d_ff // shape[1]
    p = {}
    for k, v in layer.items():
        v = (v[:, :, m * f:(m + 1) * f] if k in ("w_gate", "w_up")
             else v[:, m * f:(m + 1) * f] if k == "w_down" else v)
        p[k] = torch.from_numpy(np.ascontiguousarray(v)).requires_grad_(True)
    xl = torch.from_numpy(x[d * t:(d + 1) * t].copy()).requires_grad_(True)
    windows, experts = [], T.moe_experts

    def spy(*args, **kwargs):
        windows.append(tuple(args[3].shape))
        return experts(*args, **kwargs)
    T.moe_experts = spy
    try:
        y = T.moe_ffn(xl, p, cfg, shardings=ms)
    finally:
        T.moe_experts = experts
    (y * torch.from_numpy(ct[d * t:(d + 1) * t])).sum().backward()
    grads = {}
    for k, v in p.items():
        g = v.grad.clone()
        dist.all_reduce(g, group=mesh.get_group("data"))
        grads[k] = _np(g)
    dg, n_dp, _ = T._tp_experts(ms, cfg, f)
    e, k = cfg.n_experts, cfg.top_k
    c = math.ceil(t * n_dp * k / e * cfg.capacity_factor)
    w = min(c, t)
    with torch.no_grad():
        _, topi = T.moe_route(xl, p["router"], k)
        dest = T._window_dest(topi.reshape(-1), c, w, e, dg)
    return {"y": _np(y), "dx": _np(xl.grad), "grads": grads,
            "window": windows, "capacity": c,
            "keep": _np(dest != e * w).reshape(t, k)}


CKPT_MESHES = ((2, 2), (1, 4), (4, 1))


def ckpt_worker(rank, world, cfg, params, batches, ckpt_dir):
    """A sharded checkpoint of a "tp_fsdp" train state (parameters and
    AdamW state, f32): on (2, 2) one step from ``params``, a save with
    the specs (global arrays), and the next step in memory; then on each
    of ``CKPT_MESHES`` a restore into a state of other values, whose
    blocks must equal ``shard_tree`` of the saved state bitwise, and the
    next step from the restored blocks, which must equal the next step
    from ``shard_tree`` of the in-memory state on that mesh (on (2, 2):
    the unsaved run's own next step). Returns the saved state gathered
    (numpy leaves), each next step gathered, and the equalities."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.steps import make_lm_train_step

    opt = AdamW(lr=1e-3, weight_decay=0.01)
    full = tree_from_numpy(params, "cpu")
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]

    def on(shape):
        mesh = make_mesh(shape, AXES, "cpu")
        specs = shd.lm_param_specs(cfg, mesh, full)
        step = make_lm_train_step(cfg, opt, act_constraint=residual(mesh, cfg),
                                  **LM_KW)
        spec_tree = {"params": specs, "opt_state": shd.opt_state_specs(specs)}
        blocks = [shd.shard_tree(b, lm_batch_specs(mesh, cfg), mesh)
                  for b in tb]
        return mesh, spec_tree, step, blocks

    def equal(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(map(torch.equal, la, lb))

    mesh, spec_tree, step, blocks = on((2, 2))
    p = shd.shard_tree(full, spec_tree["params"], mesh)
    p1, s1, _ = step(p, opt.init(p), blocks[0])
    state1 = {"params": p1, "opt_state": s1}
    mgr = CheckpointManager(ckpt_dir, keep=2, async_save=True)
    mgr.save(1, state1, spec_tree=spec_tree, mesh=mesh)
    mgr.wait()
    saved = shd.gather_tree(state1, spec_tree, mesh)
    p2, s2, m2 = step(p1, s1, blocks[1])
    unsaved = shd.gather_tree({"params": p2, "opt_state": s2}, spec_tree,
                              mesh)
    out = {"saved": [_np(x) for x in tree_leaves(saved)],
           "unsaved_next": [_np(x) for x in tree_leaves(unsaved)],
           "unsaved_loss": float(m2["loss"]), "meshes": {}}
    for shape in CKPT_MESHES:
        mesh, spec_tree, step, blocks = on(shape)
        like_p = shd.shard_tree(tree_map(torch.zeros_like, full),
                                spec_tree["params"], mesh)
        like = {"params": like_p, "opt_state": opt.init(like_p)}
        restored, _ = mgr.restore(1, like, spec_tree=spec_tree, mesh=mesh)
        want = shd.shard_tree(saved, spec_tree, mesh)
        rp, rs, rm = step(restored["params"], restored["opt_state"],
                          blocks[1])
        wp, ws, wm = step(want["params"], want["opt_state"], blocks[1])
        nxt = shd.gather_tree({"params": rp, "opt_state": rs}, spec_tree,
                              mesh)
        out["meshes"][shape] = {
            "restored_equal": equal(restored, want),
            "next_equal": equal((rp, rs, rm["loss"]), (wp, ws, wm["loss"])),
            "next": [_np(x) for x in tree_leaves(nxt)],
            "loss": float(rm["loss"])}
    return out
