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
from repro_torch.tree import tree_leaves

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
