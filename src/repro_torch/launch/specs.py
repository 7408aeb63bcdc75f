"""Build (step_fn, argument structs, in/out specs) per grid cell (port of
``repro.launch.specs``).

The single description of each (architecture x shape-cell) program:
its step function, its arguments and their layouts over a mesh. Nothing
here allocates device memory: arguments are meta tensors
(``torch.empty(shape, dtype=..., device="meta")``, the reference's
``ShapeDtypeStruct``), parameter and optimizer trees are traced on
fake tensors (the reference's ``jax.eval_shape``), and specs are
``distributed.sharding.P``. A mesh is a ``DeviceMesh`` or a duck-typed
one (``.shape`` dict, ``.axis_names``): building a cell reads only its
axes, so the reference's 16 x 16 cells build on a host with no process
group.

``fn`` runs on each rank of the mesh over that rank's blocks of the
arguments (``sharding.shard_tree`` with ``in_specs``), as the reference's
program runs over global arrays under GSPMD: the LM train step under
the config's ``parallelism`` (``distributed.tp.LMPlan``), prefill and
decode under "tp_fsdp" (the serving plan), the full-graph GNN step over
the halo ops (made at the first call: collective), the sampled-subgraph
step with each rank's share of the loss and gradients summed over the
data axes, the FM steps in either layout of their tables (rows split
over every axis, or whole where the rows do not divide:
``distributed.rows``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import Arch, get_arch
from repro_torch.configs.base import (GNNConfig, RecsysConfig, ShapeCell,
                                      TransformerConfig)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.distributed.tp import LMPlan
from repro_torch.launch.mesh import (all_axes, axes_group, axes_size,
                                     data_axes, mesh_shape, model_axis)
from repro_torch.models import dimenet as dimenet_m
from repro_torch.models import fm as fm_m
from repro_torch.models import gnn as gnn_m
from repro_torch.models import nequip as nequip_m
from repro_torch.models import transformer as tfm
from repro_torch.train import steps as steps_m
from repro_torch.train.optimizer import AdamW
from repro_torch.tree import tree_map

F32, BF16, I32, BOOL = torch.float32, torch.bfloat16, torch.int32, torch.bool


def sds(shape, dtype):
    """A meta tensor of ``shape`` and ``dtype``: no storage."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def _eval_shape(fn, *args):
    """``fn(*args)``'s output tree as meta tensors, traced on fake
    tensors (no parameter is drawn or stored)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        out = fn(*args)
    return tree_map(lambda x: sds(x.shape, x.dtype), out)


def make_gnn_constrain(mesh):
    """The identity. The reference pins edge, node and triplet
    intermediates to a 1-D layout over all mesh axes, because XLA
    would otherwise replicate its global-view tensors on every device.
    Here a rank's program holds only its own block of every node, edge
    and triplet tensor (the halo ops exchange what it reads of its
    neighbours'), so there is no layout to pin and no block size this
    rank could check its tensors against."""
    def constrain(x, kind):
        return x
    return constrain


def make_moe_shardings(cfg, mesh):
    """The MoE dispatch dict: expert parallelism (experts over `model`,
    ``models.moe_ep``) where the experts divide over `model`, else TP
    inside the experts (``sharding.tp_expert_shardings``: d_ff over
    `model`, the capacity dimension over the data axes)."""
    mdl = model_axis(mesh)
    dp = data_axes(mesh)
    ep = cfg.n_experts % mesh_shape(mesh)[mdl] == 0 if mdl else False
    if ep:
        return {"ep_mesh": mesh, "dp": dp, "mdl": mdl}
    return shd.tp_expert_shardings(mesh)


def fit_specs(spec_tree, struct_tree, mesh):
    """Replicate any spec dim that does not divide the array dim evenly
    (batch=1 decode, scalar energies, ...)."""
    def fit(spec, struct):
        if not isinstance(spec, P):
            return spec
        return shd.fit_spec(spec, tuple(struct.shape), mesh)
    return tree_map(fit, spec_tree, struct_tree)


@dataclasses.dataclass
class CellProgram:
    arch: str
    cell: str
    step_name: str                 # train_step | prefill_step | serve_step
    fn: object
    args: tuple                    # meta tensors (trees)
    in_specs: tuple
    out_specs: object              # tree of P, or None
    donate: tuple = ()
    model_flops: float = 0.0       # 6·N·D-style useful flops (per step)


# ------------------------------------------------------------ LM -----------
def _lm_flops(cfg: TransformerConfig, n_tokens: int, train: bool) -> float:
    n_active = cfg.n_params_active
    mult = 6.0 if train else 2.0
    return mult * n_active * n_tokens


def _bf16(structs):
    """Serving checkpoints are bf16: every f32 leaf as bf16."""
    return tree_map(lambda x: sds(x.shape, BF16) if x.dtype == F32 else x,
                    structs)


def build_lm_cell(arch: Arch, cell: ShapeCell, mesh, *,
                  layer_mode: str = "scan") -> CellProgram:
    cfg: TransformerConfig = arch.config
    # the pure-FSDP strategy presumes global_batch >= chip count; serving
    # cells (batch 32/128/1) keep the TP layout
    strategy = cfg.parallelism if cell.kind == "train" else "tp_fsdp"
    p_structs = shd.lm_global_shapes(cfg)
    p_specs = shd.lm_param_specs(cfg, mesh, p_structs, strategy=strategy)
    dp = data_axes(mesh)
    moe_sh = make_moe_shardings(cfg, mesh) if cfg.moe else None

    if cell.kind == "train":
        opt = AdamW(lr=1e-4, weight_decay=0.01)
        o_structs = opt.init(p_structs)
        o_specs = shd.opt_state_specs(p_specs)
        batch = {"tokens": sds((cell.global_batch, cell.seq_len), I32),
                 "labels": sds((cell.global_batch, cell.seq_len), I32)}
        if strategy == "fsdp":
            b_specs = fit_specs({"tokens": P(all_axes(mesh), None),
                                 "labels": P(all_axes(mesh), None)},
                                batch, mesh)
            act = NamedSharding(mesh, P(all_axes(mesh), None, None))
        else:
            b_specs = shd.lm_batch_specs(mesh)
            act = NamedSharding(mesh, P(dp, model_axis(mesh), None))
        fn = steps_m.make_lm_train_step(cfg, opt, remat=True, q_chunk=512,
                                        k_chunk=1024, xent_chunk=256,
                                        layer_mode=layer_mode,
                                        act_constraint=act,
                                        moe_shardings=moe_sh)
        return CellProgram(
            arch.name, cell.name, "train_step", fn,
            (p_structs, o_structs, batch),
            (p_specs, o_specs, b_specs),
            (p_specs, o_specs, {"loss": P()}),
            donate=(0, 1),
            model_flops=_lm_flops(cfg, cell.global_batch * cell.seq_len,
                                  True))

    # prefill and decode run under the serving plan ("tp_fsdp")
    serve_cfg = dataclasses.replace(cfg, parallelism=strategy)
    plan = LMPlan(serve_cfg, mesh, moe_sh, batch=cell.global_batch)
    if cell.kind == "prefill":
        fn = steps_m.make_lm_prefill_step(serve_cfg, max_len=cell.seq_len,
                                          q_chunk=512, k_chunk=1024,
                                          layer_mode=layer_mode,
                                          moe_shardings=moe_sh, plan=plan)
        tokens = sds((cell.global_batch, cell.seq_len), I32)
        return CellProgram(
            arch.name, cell.name, "prefill_step", fn,
            (_bf16(p_structs), tokens),
            (p_specs, P(dp, None)),
            None,
            model_flops=_lm_flops(cfg, cell.global_batch * cell.seq_len,
                                  False))

    if cell.kind == "decode":
        t_buf = tfm.cache_len(cfg, cell.seq_len)
        kv = (cfg.n_layers, cell.global_batch, t_buf, cfg.n_kv_heads,
              cfg.d_head)
        cache = {"k": sds(kv, BF16), "v": sds(kv, BF16),
                 "pos": sds((cell.global_batch, t_buf), I32),
                 "index": sds((), I32)}
        c_specs = fit_specs(shd.lm_cache_specs(mesh), cache, mesh)
        tokens = sds((cell.global_batch, 1), I32)
        tok_spec = fit_specs(P(dp, None), tokens, mesh)
        fn = steps_m.make_lm_decode_step(serve_cfg, k_chunk=min(t_buf, 2048),
                                         layer_mode=layer_mode,
                                         moe_shardings=moe_sh, plan=plan)
        # the cache comes back in its own layout, so it can be donated
        logit_spec = fit_specs(P(dp, None, None),
                               sds((cell.global_batch, 1, cfg.vocab), F32),
                               mesh)
        return CellProgram(
            arch.name, cell.name, "serve_step", fn,
            (_bf16(p_structs), cache, tokens),
            (p_specs, c_specs, tok_spec),
            (logit_spec, c_specs), donate=(1,),
            model_flops=_lm_flops(cfg, cell.global_batch, False))

    raise ValueError(cell.kind)


# ------------------------------------------------------------ GNN ----------
def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _graph_sizes(cell: ShapeCell, pad: int = 8192):
    """Node/edge counts padded to shard evenly over 512 devices; padding
    rows are masked (node_mask / sentinel segment ids), standard practice
    for static-shape graph batching."""
    if cell.kind == "graph_batched":       # molecule: batch of small graphs
        n = cell.n_nodes * cell.global_batch
        e = cell.n_edges * cell.global_batch
        return _pad_to(n, pad), _pad_to(e, pad), cell.global_batch
    return _pad_to(cell.n_nodes, pad), _pad_to(cell.n_edges, pad), 1


def _gnn_batch_structs(cfg: GNNConfig, cell: ShapeCell):
    """Full-graph / batched-molecule flat batch (no leading subgraph dim)."""
    n, e, n_mols = _graph_sizes(cell)
    d_feat = max(cell.d_feat, 1)
    if cfg.kind in ("gcn", "gatedgcn", "meshgraphnet"):
        b = {"senders": sds((e,), I32), "receivers": sds((e,), I32),
             "node_feat": sds((n, d_feat), F32),
             "edge_feat": sds((e, 4), F32),
             "labels": sds((n,), I32), "node_mask": sds((n,), BOOL)}
    else:  # geometric models ignore d_feat: inputs are species + positions
        t = 2 * e if cell.n_nodes > 10_000 else 4 * e
        b = {"z": sds((n,), I32), "pos": sds((n, 3), F32),
             "edge_src": sds((e,), I32), "edge_dst": sds((e,), I32),
             "mol_id": sds((n,), I32), "energy": sds((n_mols,), F32)}
        if cfg.kind == "dimenet":
            b["trip_kj"] = sds((t,), I32)
            b["trip_ji"] = sds((t,), I32)
    return b, n_mols


def _gnn_params(cfg: GNNConfig, cell: ShapeCell):
    d_feat = max(cell.d_feat, 1)
    gen = torch.Generator()
    if cfg.kind == "gcn":
        return _eval_shape(gnn_m.gcn_init, cfg, d_feat, gen, "cpu")
    if cfg.kind == "gatedgcn":
        return _eval_shape(gnn_m.gatedgcn_init, cfg, d_feat, 4, gen, "cpu")
    if cfg.kind == "meshgraphnet":
        return _eval_shape(gnn_m.meshgraphnet_init, cfg, d_feat, 4, gen,
                           "cpu")
    if cfg.kind == "dimenet":
        return _eval_shape(dimenet_m.dimenet_init, cfg, gen, "cpu")
    if cfg.kind == "nequip":
        return _eval_shape(nequip_m.nequip_init, cfg, gen, "cpu")
    raise ValueError(cfg.kind)


def _gnn_flops(cfg: GNNConfig, n: int, e: int, d_feat: int,
               train: bool) -> float:
    d = cfg.d_hidden
    if cfg.kind == "gcn":
        f = 2 * n * d_feat * d + 2 * e * d
    elif cfg.kind == "gatedgcn":
        f = cfg.n_layers * (2 * n * 5 * d * d + 2 * e * d * 3)
    elif cfg.kind == "meshgraphnet":
        mlp_e = 2 * (3 * d) * d + 2 * d * d
        mlp_n = 2 * (2 * d) * d + 2 * d * d
        f = cfg.n_layers * (e * mlp_e + n * mlp_n)
    elif cfg.kind == "dimenet":
        t = 2 * e if n > 10_000 else 4 * e
        sr = cfg.n_spherical * cfg.n_radial
        f = cfg.n_layers * (2 * t * sr * cfg.n_bilinear * d
                            + 2 * e * 4 * d * d)
    else:  # nequip
        paths = (cfg.l_max + 1) ** 3
        f = cfg.n_layers * (2 * e * paths * cfg.d_hidden * 9
                            + 2 * n * (cfg.l_max + 1) * d * d)
    return f * (3.0 if train else 1.0)


def build_gnn_cell(arch: Arch, cell: ShapeCell, mesh) -> CellProgram:
    cfg: GNNConfig = arch.config
    p_structs = _gnn_params(cfg, cell)
    p_specs = shd.gnn_param_specs(cfg, mesh, p_structs)
    opt = AdamW(lr=1e-3)
    o_structs = opt.init(p_structs)
    o_specs = shd.opt_state_specs(p_specs)

    if cell.kind == "graph_minibatch":
        # sampled-subgraph training: leading dim = one subgraph per data
        # group; inner sizes from the fanout worst case (sampler.max_sizes)
        from repro_torch.data.sampler import max_sizes
        dp = data_axes(mesh)
        n_sub = axes_size(mesh, dp)
        mn, me = max_sizes(cell.batch_nodes, cell.fanout)
        inner = dataclasses.replace(cell, kind="graph_full", n_nodes=mn,
                                    n_edges=me)
        flat, _ = _gnn_batch_structs(cfg, inner)
        batch = {k: sds((n_sub,) + tuple(v.shape), v.dtype)
                 for k, v in flat.items()}
        b_specs = fit_specs(shd.minibatch_specs(mesh, batch.keys()), batch,
                            mesh)
        built = {}

        def fn(params, opt_state, batch):
            # a rank holding its data group's block of the subgraphs sums
            # its share of the mean loss and of the gradients over the
            # data axes (the group made at the first call: collective); a
            # caller holding all n_sub needs no group
            block = next(iter(batch.values())).shape[0] < n_sub
            if block not in built:
                built[block] = steps_m.make_gnn_minibatch_step(
                    cfg, opt, n_sub,
                    group=axes_group(mesh, dp) if block else None)
            return built[block](params, opt_state, batch)
        flops = n_sub * _gnn_flops(cfg, mn, me, max(cell.d_feat, 1), True)
        return CellProgram(arch.name, cell.name, "train_step", fn,
                           (p_structs, o_structs, batch),
                           (p_specs, o_specs, b_specs),
                           (p_specs, o_specs, {"loss": P()}),
                           donate=(0, 1), model_flops=flops)

    flat, _ = _gnn_batch_structs(cfg, cell)
    b_specs = fit_specs(shd.graph_batch_specs(mesh, flat.keys()), flat, mesh)
    n, e, _ = _graph_sizes(cell)
    train = True  # all remaining GNN shapes are training regimes

    step = []

    def fn(params, opt_state, batch):
        # the halo ops are collective: made where every rank runs the
        # program (its first call), not where the cell is built
        if not step:
            from repro_torch.distributed.halo import make_halo_ops
            step.append(steps_m.make_gnn_train_step(
                cfg, opt, constrain=make_gnn_constrain(mesh),
                gops=make_halo_ops(mesh, all_axes(mesh)), remat=True))
        return step[0](params, opt_state, batch)
    flops = _gnn_flops(cfg, n, e, max(cell.d_feat, 1), train)
    return CellProgram(arch.name, cell.name, "train_step", fn,
                       (p_structs, o_structs, flat),
                       (p_specs, o_specs, b_specs),
                       (p_specs, o_specs, {"loss": P()}),
                       donate=(0, 1), model_flops=flops)


# --------------------------------------------------------- recsys ----------
def _fm_fn(make, mesh, p_specs):
    """``make(shards)``'s step over a rank's blocks, in the layout of the
    tables' specs (``distributed.rows.FMShards``: rows split over every
    axis, or whole), made at the first call (its groups are
    collective)."""
    step = []

    def fn(*args):
        if not step:
            from repro_torch.distributed.rows import FMShards
            rows = p_specs["v"][0] is not None
            step.append(make(FMShards(mesh, rows)))
        return step[0](*args)
    return fn


def build_fm_cell(arch: Arch, cell: ShapeCell, mesh) -> CellProgram:
    cfg: RecsysConfig = arch.config
    p_structs = _eval_shape(fm_m.fm_init, cfg, torch.Generator(), "cpu")
    p_specs = shd.fm_param_specs(cfg, mesh, p_structs)
    dp = data_axes(mesh)
    f = cfg.n_sparse

    if cell.kind == "rec_train":
        opt = AdamW(lr=1e-3)
        o_structs = opt.init(p_structs)
        o_specs = shd.opt_state_specs(p_specs)
        batch = {"idx": sds((cell.global_batch, f), I32),
                 "labels": sds((cell.global_batch,), F32)}
        fn = _fm_fn(lambda sh: steps_m.make_fm_train_step(cfg, opt,
                                                           shards=sh),
                    mesh, p_specs)
        flops = 2.0 * cell.global_batch * f * cfg.embed_dim * 3 * 3
        return CellProgram(arch.name, cell.name, "train_step", fn,
                           (p_structs, o_structs, batch),
                           (p_specs, o_specs, shd.fm_batch_specs(mesh)),
                           (p_specs, o_specs, {"loss": P()}),
                           donate=(0, 1), model_flops=flops)

    if cell.kind == "rec_serve":
        batch = {"idx": sds((cell.global_batch, f), I32)}
        fn = _fm_fn(lambda sh: steps_m.make_fm_serve_step(cfg, sh), mesh,
                    p_specs)
        flops = 2.0 * cell.global_batch * f * cfg.embed_dim * 3
        return CellProgram(arch.name, cell.name, "serve_step", fn,
                           (p_structs, batch),
                           (p_specs, {"idx": P(dp, None)}),
                           None, model_flops=flops)

    # retrieval: one user context against n_candidates items (padded up
    # to a 1024-divisible count; padding candidates score as junk rows)
    n_user = 20
    n_cand_f = f - n_user
    fn = _fm_fn(lambda sh: steps_m.make_fm_retrieval_step(cfg, n_user, sh),
                mesh, p_specs)
    user = sds((n_user,), I32)
    n_cand = -(-cell.n_candidates // 1024) * 1024
    cand = sds((n_cand, n_cand_f), I32)
    flops = 2.0 * cell.n_candidates * n_cand_f * cfg.embed_dim * 3
    return CellProgram(arch.name, cell.name, "serve_step", fn,
                       (p_structs, user, cand),
                       (p_specs, P(), P(all_axes(mesh), None)),
                       None, model_flops=flops)


# ---------------------------------------------------------- entry ----------
def build_cell(arch_name: str, cell_name: str, mesh, *,
               layer_mode: str = "scan",
               n_layers_override: int = 0) -> CellProgram:
    arch = get_arch(arch_name)
    cell = next(c for c in arch.shapes if c.name == cell_name)
    if cell.skip:
        raise SkippedCell(f"{arch_name}/{cell_name}: {cell.skip}")
    if isinstance(arch.config, TransformerConfig):
        if n_layers_override:
            arch = dataclasses.replace(arch, config=dataclasses.replace(
                arch.config, n_layers=n_layers_override))
        return build_lm_cell(arch, cell, mesh, layer_mode=layer_mode)
    if isinstance(arch.config, GNNConfig):
        return build_gnn_cell(arch, cell, mesh)
    if isinstance(arch.config, RecsysConfig):
        return build_fm_cell(arch, cell, mesh)
    raise TypeError(type(arch.config))


class SkippedCell(Exception):
    pass
