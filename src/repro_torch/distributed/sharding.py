"""Per-family sharding rules (port of ``repro.distributed.sharding``).

| family        | strategy                                                  |
|---------------|-----------------------------------------------------------|
| dense LM      | Megatron TP over `model` (heads + d_ff), DP over pod/data |
| MoE, E >= |model| | expert parallelism: experts sharded over `model`      |
| MoE, E <  |model| | tensor parallelism inside experts (d_ff over `model`) |
| GNN           | weights replicated; nodes/edges sharded over all axes    |
| recsys FM     | embedding rows sharded over ALL axes; batch over dp axes |

A ``PartitionSpec`` has one entry per leading dimension: an axis name, a
tuple of names, or ``None`` (replicated). The rules are regexes on a
leaf's keypath, which ``repro_torch.tree.flatten_with_path`` writes as
JAX does (``['layers']/['wq']``), so the port's spec tree equals the
reference's leaf for leaf. A dimension sharded over several axes is laid
out first-axis-major, as JAX lays out ``P(("data", "model"))``:
``local_slice`` gives rank r the block that JAX's
``devices_indices_map`` gives the device at r's mesh coordinates.

Placement is the port's own: ``shard_tree`` cuts each leaf to this
rank's block, ``gather_tree`` puts the blocks of every rank of the mesh
back together. ``with_sharding_constraint`` moves a rank's block from
its layout to the constrained one (``distributed.tp.relayout``: an
all-gather, a slice or an all-to-all over the named axes), the reverse
change as its backward; the global values stay as they are, as in the
reference.
"""
from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import GNNConfig, RecsysConfig, TransformerConfig
from repro_torch.launch.mesh import (all_axes, axes_group, axes_size,
                                     coordinates, data_axes, mesh_shape,
                                     model_axis)
from repro_torch.train.optimizer import AdamWState
from repro_torch.tree import flatten_with_path, tree_map, tree_unflatten


def _entry(e):
    """One spec entry as JAX normalizes it: a tuple of one axis is that
    axis, an empty tuple is None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class PartitionSpec:
    """``jax.sharding.PartitionSpec``: entries per dimension (missing
    trailing entries are replicated). Not a tuple, so that the port's
    tree functions take a spec as one leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(map(_entry, entries))

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        return (isinstance(other, PartitionSpec)
                and self._entries == other._entries)

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(map(repr, self._entries)) + ")"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    def local_slice(self, shape, rank: int) -> tuple:
        return local_slice(self.spec, shape, self.mesh, rank)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _match(path: str, rules):
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return P()


def fit_spec(spec, shape, mesh) -> PartitionSpec:
    """``spec`` over every dimension of ``shape``, each entry that does
    not divide its dimension evenly replaced by ``None`` (replicated)."""
    fixed = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is not None and int(dim) % axes_size(mesh, ax) != 0:
            ax = None
        fixed.append(ax)
    return P(*fixed)


def _tree_specs(tree, rules, mesh):
    specs = [fit_spec(_match(path, rules), tuple(leaf.shape), mesh)
             for path, leaf in flatten_with_path(tree)]
    return tree_unflatten(tree, specs)


def lm_param_rules(cfg: TransformerConfig, mesh, fsdp: bool = True,
                   strategy: str = None):
    """TP over `model` + (fsdp=True) ZeRO-3: the non-TP dim of every
    weight is sharded over the data axes, so no rank ever holds a full
    DP replica of params/optimizer state. ``strategy="fsdp"`` shards
    every weight over every mesh axis, with no tensor axis."""
    mdl = model_axis(mesh)
    dp = data_axes(mesh)
    strategy = strategy or getattr(cfg, "parallelism", "tp_fsdp")
    if strategy == "fsdp":
        mdl = None
        fs = tuple(dp) + (model_axis(mesh),) if model_axis(mesh) else dp
    else:
        fs = dp if fsdp else None
    lyr = r"\['layers'\].*"
    rules = [
        (r"\['embed'\]", P(fs, None)),
        (r"\['lm_head'\]", P(fs, mdl)),
        (r"_norm", P()),
        (lyr + r"\['w[qkv]'\]", P(None, fs, mdl)),
        (lyr + r"\['wo'\]", P(None, mdl, fs)),
        (lyr + r"\['router'\]", P()),
    ]
    if cfg.moe:
        ep = cfg.n_experts % mesh_shape(mesh)[mdl] == 0 if mdl else False
        if ep:   # expert parallelism (qwen3-moe: 128 experts / 16)
            rules += [
                (lyr + r"\['w_(gate|up|down)'\]", P(None, mdl, fs, None)),
            ]
        else:    # TP inside experts (mixtral: 8 experts < 16 ranks)
            rules += [
                (lyr + r"\['w_(gate|up)'\]", P(None, None, fs, mdl)),
                (lyr + r"\['w_down'\]", P(None, None, mdl, fs)),
            ]
    else:
        rules += [
            (lyr + r"\['w_(gate|up)'\]", P(None, fs, mdl)),
            (lyr + r"\['w_down'\]", P(None, mdl, fs)),
        ]
    return rules


def lm_param_specs(cfg: TransformerConfig, mesh, params_shape,
                   strategy: str = None):
    return _tree_specs(params_shape,
                       lm_param_rules(cfg, mesh, strategy=strategy), mesh)


def gnn_param_specs(cfg: GNNConfig, mesh, params_shape):
    return _tree_specs(params_shape, [(r".*", P())], mesh)


def fm_param_specs(cfg: RecsysConfig, mesh, params_shape):
    rows = P(all_axes(mesh), None)
    return _tree_specs(params_shape, [
        (r"\['v'\]", rows),
        (r"\['w'\]", rows),
        (r".*", P()),
    ], mesh)


def opt_state_specs(param_specs):
    """AdamW state mirrors param shardings; step is replicated."""
    return AdamWState(P(), param_specs, param_specs)


def param_specs_for(cfg, mesh, params_shape):
    if isinstance(cfg, TransformerConfig):
        return lm_param_specs(cfg, mesh, params_shape)
    if isinstance(cfg, GNNConfig):
        return gnn_param_specs(cfg, mesh, params_shape)
    if isinstance(cfg, RecsysConfig):
        return fm_param_specs(cfg, mesh, params_shape)
    raise TypeError(type(cfg))


# ------------------------------------------------------- batch specs -------
def lm_batch_specs(mesh):
    dp = data_axes(mesh)
    return {"tokens": P(dp, None), "labels": P(dp, None)}


def lm_cache_specs(mesh):
    dp = data_axes(mesh)
    return {"k": P(None, dp, None, None, None),
            "v": P(None, dp, None, None, None),
            "pos": P(dp, None), "index": P()}


def graph_batch_specs(mesh, keys):
    """Full-graph: shard nodes/edges over every axis (1-D distribution)."""
    ax = all_axes(mesh)
    spec = {}
    for k in keys:
        if k in ("senders", "receivers", "edge_mask", "edge_weights",
                 "edge_src", "edge_dst", "trip_kj", "trip_ji"):
            spec[k] = P(ax)
        elif k in ("node_feat", "edge_feat", "pos"):
            spec[k] = P(ax, None)
        elif k in ("labels", "node_mask", "z", "mol_id", "energy"):
            spec[k] = P(ax)
        else:
            spec[k] = P()
    return spec


def minibatch_specs(mesh, keys):
    """Sampled subgraphs: leading batch dim over data axes."""
    dp = data_axes(mesh)
    spec = {}
    for k in keys:
        spec[k] = P(dp, None) if k != "n_mols" else P()
    return spec


def fm_batch_specs(mesh):
    dp = data_axes(mesh)
    return {"idx": P(dp, None), "labels": P(dp)}


def to_named(tree_specs, mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), tree_specs)


# ------------------------------------------------------- placement ---------
def local_slice(spec, shape, mesh, rank: int) -> tuple:
    """The block of a ``shape`` array that ``rank`` holds under ``spec``:
    one ``slice`` per dimension. A dimension sharded over axes
    (a, b, ...) is cut into |a|·|b|·... blocks, block index
    ``ravel_multi_index((coord[a], coord[b], ...))`` (first axis major).
    Raises where an entry does not divide its dimension."""
    coord = coordinates(mesh, rank)
    sizes = mesh_shape(mesh)
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            out.append(slice(0, int(dim)))
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        n = int(np.prod([sizes[a] for a in axes]))
        if int(dim) % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"divide over {axes} ({n} ranks)")
        chunk = int(dim) // n
        block = int(np.ravel_multi_index([coord[a] for a in axes],
                                         [sizes[a] for a in axes]))
        out.append(slice(block * chunk, (block + 1) * chunk))
    return tuple(out)


def _specs_like(tree, spec_tree) -> list:
    leaves = [leaf for _, leaf in flatten_with_path(tree)]
    specs = [s for _, s in flatten_with_path(spec_tree)]
    if len(leaves) != len(specs) or not all(map(_is_spec, specs)):
        raise ValueError("the spec tree does not match the tree")
    return leaves, specs


def shard_tree(tree, spec_tree, mesh, rank: int = None):
    """Each leaf (the full array, the same on every rank) cut to ``rank``'s
    block (this process's rank by default); a copy, contiguous."""
    rank = dist.get_rank() if rank is None else rank
    leaves, specs = _specs_like(tree, spec_tree)
    return tree_unflatten(tree, [
        leaf[local_slice(s, tuple(leaf.shape), mesh, rank)].clone()
        for leaf, s in zip(leaves, specs)])


def _full_shape(spec, local_shape, mesh) -> tuple:
    """The global shape whose blocks under ``spec`` are ``local_shape``."""
    return tuple(int(d) * axes_size(mesh, spec[i] if i < len(spec)
                                     else None)
                 for i, d in enumerate(local_shape))


def gather_tree(tree, spec_tree, mesh):
    """The full leaves from every rank's blocks: one ``all_gather`` per
    leaf over the mesh's ranks, each block written at its rank's slice.
    Collective over the mesh: every rank of it calls, with the same
    tree."""
    leaves, specs = _specs_like(tree, spec_tree)
    group = axes_group(mesh, all_axes(mesh))
    ranks = dist.get_process_group_ranks(group)
    out = []
    for leaf, s in zip(leaves, specs):
        parts = [torch.empty_like(leaf) for _ in ranks]
        dist.all_gather(parts, leaf.contiguous(), group=group)
        full = leaf.new_empty(_full_shape(s, tuple(leaf.shape), mesh))
        for r, part in zip(ranks, parts):
            full[local_slice(s, tuple(full.shape), mesh, r)] = part
        out.append(full)
    return tree_unflatten(tree, out)


def with_sharding_constraint(x: torch.Tensor, sharding,
                             src=None) -> torch.Tensor:
    """``jax.lax.with_sharding_constraint`` on one rank's tensor: ``x``,
    this rank's block under the spec ``src`` (default ``P()``: the whole
    tensor), as its block under ``sharding`` (a ``NamedSharding``: no
    more entries than dimensions, each naming axes of its mesh). The
    values of the global tensor do not change; its layout does, by
    ``distributed.tp.relayout`` (a differentiable layout change whose
    backward is the reverse one). Over axes of one rank every
    collective still runs and moves the same bits."""
    from repro_torch.distributed.tp import relayout

    spec, mesh = sharding.spec, sharding.mesh
    src = P() if src is None else getattr(src, "spec", src)
    shape = mesh_shape(mesh)
    for s in (spec, src):
        if len(s) > x.dim():
            raise ValueError(f"{s} has more entries than the tensor's "
                             f"{x.dim()} dimensions")
        for ax in s:
            names = () if ax is None else (ax,) if isinstance(ax, str) \
                else ax
            if not set(names) <= set(shape):
                raise ValueError(f"{s} names axes that are not on the "
                                 f"mesh {shape}")
    return relayout(x, src, spec, mesh)


def same_layout(a, b, mesh) -> bool:
    """Whether specs ``a`` and ``b`` lay a tensor out alike on ``mesh``
    (axes of one rank split nothing)."""
    def norm(spec):
        out = []
        for e in spec:
            names = () if e is None else (e,) if isinstance(e, str) else e
            out.append(tuple(n for n in names if axes_size(mesh, n) > 1))
        while out and not out[-1]:
            out.pop()
        return out
    return norm(a) == norm(b)


def lm_global_shapes(cfg: TransformerConfig):
    """The LM's parameter tree as meta tensors of the global shapes
    (``transformer.init_params``'s structure), for the spec rules."""
    from repro_torch.models.transformer import _layer_shapes

    def meta(shape):
        return torch.empty(shape, device="meta")
    tree = {"embed": meta((cfg.vocab, cfg.d_model)),
            "layers": {k: meta((cfg.n_layers,) + shape)
                       for k, (shape, _) in _layer_shapes(cfg).items()},
            "final_norm": meta((cfg.d_model,))}
    if not cfg.tie_embeddings:
        tree["lm_head"] = meta((cfg.d_model, cfg.vocab))
    return tree


def tp_expert_shardings(mesh) -> dict:
    """The MoE dispatch constraints of TP inside the experts
    (``launch/specs.py`` ``make_moe_shardings``'s second branch of the
    reference): the capacity dimension over the data axes, d_ff over
    `model`. ``moe_shardings=`` this dict runs ``transformer.moe_ffn``
    with d_ff split over `model` whatever the expert count."""
    from repro_torch.distributed.tp import tp_expert_dict
    return tp_expert_dict(mesh, data_axes(mesh), model_axis(mesh))
