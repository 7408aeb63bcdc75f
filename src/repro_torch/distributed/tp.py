"""Tensor-, sequence- and fully-sharded data-parallel collectives, and
the plan that runs the LM over a (data, model) mesh.

The reference gets these from GSPMD through its annotations (the
parameter specs of ``sharding.lm_param_rules``, ``act_constraint``, the
MoE dispatch constraints). The port has no compiler to insert them, so
the sharded LM issues them itself, each as an ``autograd.Function``
over a process group:

- ``copy_to``: identity; backward all-reduce (Megatron's f: the
  replicated input of a column-parallel product);
- ``sum_over``: all-reduce; backward identity (Megatron's g: the
  partial output of a row-parallel product);
- ``gather``: all-gather along a dimension; backward reduce-scatter
  (SP: the sequence-split residual into a column-parallel product;
  FSDP: one weight over its ``fs`` axes);
- ``scatter``: reduce-scatter; backward all-gather (SP: a row-parallel
  product back to the sequence split);
- ``psum``: all-reduce; backward all-reduce (its exact transpose: a sum
  of per-rank shares);
- ``relayout``: an all-gather, a slice or an all-to-all; backward the
  reverse layout change (``with_sharding_constraint``).

Convention (the reference's global view): a tensor replicated over a
group holds, on each of its ranks, the whole value and the whole
cotangent. A column-parallel product leaves a partial cotangent on its
input (each rank's column block contributes a part), which ``copy_to``
or ``gather`` sums; a row-parallel product leaves a partial value, which
``sum_over`` or ``scatter`` sums. A weight replicated over an axis its
computation is split over (a norm scale over the sequence split, any
weight over the batch) gets a partial gradient, which the train step
sums over exactly those axes (``LMPlan.grad_axes``). ``psum`` is the
other convention (the sum of every rank's loss share is the loss; the
halo GNN steps): the energy models sum their molecules' partial energies
with it.

Each of these Functions issues its collective whatever the group's
size (over one rank it is a copy, so the sharded step on a (1, 1) mesh
has the unsharded step's bits; ``relayout`` alone leaves a tensor as it
is where two layouts differ only by axes of one rank), and each
collective ticks ``COUNTS`` by kind.
"""
from __future__ import annotations

import collections
import re

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axes_group, axis_names, mesh_shape

COUNTS = collections.Counter()
# torch >= 2.13 names these *_single and deprecates the older names
_AG = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_RS = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def reset_counts() -> None:
    COUNTS.clear()


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def _axes_of(spec) -> set:
    """Every axis a spec splits over."""
    return {a for e in spec for a in _axes(e)}


# ------------------------------------------------------------ primitives ---
def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    COUNTS["all_reduce"] += 1
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x, dim: int, group):
    COUNTS["all_gather"] += 1
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    _AG(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x, dim: int, group):
    COUNTS["reduce_scatter"] += 1
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"divide over {n} ranks")
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    _RS(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _block(x, dim: int, group):
    """This rank's block of ``x`` along ``dim`` (a copy)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"divide over {n} ranks")
    k = x.shape[dim] // n
    return x.narrow(dim, me * k, k).contiguous()


def _all_to_all(x, split_dim: int, cat_dim: int, group):
    """Block r of ``x`` along ``split_dim`` goes to rank r; the blocks
    received are concatenated along ``cat_dim`` in rank order."""
    COUNTS["all_to_all"] += 1
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of {tuple(x.shape)} does "
                         f"not divide over {n} ranks")
    send = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(torch.unbind(recv), dim=cat_dim).contiguous()


# ------------------------------------------------------- the Functions -----
class CopyToGroup(torch.autograd.Function):
    """Identity; the backward sums the cotangent over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over the group; the backward passes the
    (replicated) cotangent through."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _GatherSlice(torch.autograd.Function):
    """Layout change split -> replicated (global view: the backward takes
    this rank's block of the whole cotangent)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group), None, None


class _SliceGather(torch.autograd.Function):
    """Layout change replicated -> split (the backward gathers the
    blocks' cotangents into the whole one)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return _all_to_all(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _all_to_all(g, cat_dim, split_dim, ctx.group), None, None, \
            None


def copy_to(x, group):
    return CopyToGroup.apply(x, group)


def sum_over(x, group):
    return SumOverGroup.apply(x, group)


def psum(x, group):
    return _Psum.apply(x, group)


def gather(x, dim: int, group):
    """All-gather along ``dim``; the backward reduce-scatters (sums the
    ranks' partial cotangents, keeps this rank's block). The sequence-
    parallel gather, and the FSDP gather of a weight over ``fs``."""
    return _Gather.apply(x, dim, group)


def scatter(x, dim: int, group):
    """Reduce-scatter along ``dim``; the backward all-gathers."""
    return _Scatter.apply(x, dim, group)


def all_max(x, group):
    """All-reduce (max), no gradient."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def all_sum(x, group):
    """All-reduce (sum), no gradient."""
    return _all_reduce(x.detach(), group)


def unshard(x, dim: int, group):
    """Layout change split -> replicated along ``dim`` (global view)."""
    return _GatherSlice.apply(x, dim, group)


def shard(x, dim: int, group):
    """Layout change replicated -> split along ``dim`` (global view)."""
    return _SliceGather.apply(x, dim, group)


def relayout(x, src, dst, mesh):
    """``x`` (this rank's block under spec ``src``) as its block under
    ``dst``: an all-to-all where one axis group moves from one
    dimension to another, an all-gather where a dimension loses its
    axes, a slice where it gains them. Each is the global view's
    identity, so the backward is the reverse change. Axes of one rank
    split nothing: where the two layouts differ only by them, ``x`` is
    returned as it is."""
    n = x.dim()
    shape = mesh_shape(mesh)

    def entry(spec, i):     # axes of one rank split nothing
        return tuple(a for a in _axes(spec[i] if i < len(spec) else None)
                     if shape[a] > 1)
    src = [entry(src, i) for i in range(n)]
    dst = [entry(dst, i) for i in range(n)]
    if src == dst:
        return x
    if not hasattr(mesh, "get_group"):
        raise ValueError(f"a layout change over {shape} needs a DeviceMesh "
                         "with its process groups")
    moved = set()
    for i in range(n):
        if src[i] and src[i] != dst[i] and not dst[i]:
            for j in range(n):
                if j != i and dst[j] == src[i] and not src[j]:
                    x = _AllToAll.apply(x, j, i, axes_group(mesh, src[i]))
                    moved |= {i, j}
                    break
    for i in range(n):
        if i not in moved and src[i] and src[i] != dst[i]:
            x = unshard(x, i, axes_group(mesh, src[i]))
    for i in range(n):
        if i not in moved and dst[i] and src[i] != dst[i]:
            x = shard(x, i, axes_group(mesh, dst[i]))
    return x


# ------------------------------------------------------------ the LM plan --
LAYER_LEAF = re.compile(r"\['layers'\]/\['(\w+)'\]")


def _leaf_name(path: str) -> str:
    m = LAYER_LEAF.search(path)
    return m.group(1) if m else re.findall(r"\['(\w+)'\]", path)[-1]


TP_EXPERT_KEYS = ("xs", "h", "flat", "tokens")


def is_tp_expert_dict(moe_shardings) -> bool:
    """Whether ``moe_shardings`` is the tensor-parallel MoE dict (raises
    where one is given without all four of its constraints)."""
    if not isinstance(moe_shardings, dict) or "ep_mesh" in moe_shardings:
        return False
    missing = [k for k in TP_EXPERT_KEYS if k not in moe_shardings]
    if missing:
        raise ValueError(f"the tensor-parallel MoE dict needs "
                         f"{TP_EXPERT_KEYS}; {missing} missing")
    return True


def tp_expert_dict(mesh, dp: tuple, mdl) -> dict:
    """The MoE dispatch constraints of TP inside the experts: the
    capacity dimension over the axes ``dp`` (the tokens' batch axes),
    d_ff over ``mdl`` (None: whole). ``transformer.moe_ffn`` reads
    ``"tokens"`` (whose tokens rank the capacity together) and
    ``"h"`` (the d_ff split)."""
    from repro_torch.distributed.sharding import NamedSharding, P

    dp = tuple(dp)
    flat = dp + ((mdl,) if mdl else ())
    return {"xs": NamedSharding(mesh, P(None, dp, None)),
            "h": NamedSharding(mesh, P(None, dp, mdl)),
            "flat": NamedSharding(mesh, P(flat, None)),
            "tokens": NamedSharding(mesh, P(dp, None))}


def residual_spec(cfg, mesh):
    """The residual stream's layout under the config's ``parallelism``,
    the reference's ``act_constraint``: ``P(dp, model, None)`` under
    "tp_fsdp" (sequence-parallel over `model`), ``P(all axes, None,
    None)`` under "fsdp"."""
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import all_axes, data_axes, model_axis

    if _strategy(cfg) == "fsdp":
        return P(tuple(all_axes(mesh)), None, None)
    return P(tuple(data_axes(mesh)) or None, model_axis(mesh), None)


def _strategy(cfg) -> str:
    strategy = getattr(cfg, "parallelism", "tp_fsdp")
    if strategy not in ("tp_fsdp", "fsdp"):
        raise ValueError(f"parallelism {strategy!r}: 'tp_fsdp' or 'fsdp'")
    return strategy


class LMPlan:
    """How the LM runs over ``mesh`` under the config's ``parallelism``
    ("tp_fsdp": Megatron TP + SP over `model`, ZeRO-3 over the data
    axes; "fsdp": ZeRO-3 over every axis, the batch over every axis).

    Built from the parameter specs of the config's global shapes
    (``sharding.lm_param_specs``), so a rank holds each leaf's block
    under its spec (``sharding.shard_tree``). It names, for every leaf,
    the dimensions its layer gathers over ``fs`` (``gathers``) and the
    axes its gradient is summed over after the backward
    (``grad_axes``), and the mode of each block:

    - attention: ``"heads"`` where wq, wk and wv are column-split over
      `model` into whole heads (each rank's query heads over its own kv
      heads), ``"gathered"`` where a rank's block is not whole heads
      (the projections are gathered over `model` before attention, which
      then runs on every head on every rank), ``"replicated"`` where the
      weights are not split over `model`;
    - dense FFN and TP experts: ``"split"`` where d_ff is split over
      `model`, else ``"replicated"``;
    - MoE: ``"ep"`` (experts over `model`, ``models.moe_ep``) or
      ``"tp"`` (TP inside the experts), as ``moe_shardings`` says, else
      as the rules pick (E divisible by |model|);
    - the head: ``"vocab"`` (vocab-parallel cross-entropy) where the
      head is split over `model`, else ``"seq"`` (each rank's sequence
      block against the whole vocabulary).

    Serving (``transformer.prefill`` / ``decode_step`` with ``plan=``)
    runs the same blocks with no remat and no gradient, the residual
    stream whole over `model`. ``batch``: the global batch of those
    passes; where it does not divide over the batch axes it is whole on
    every rank (the reference's ``fit_specs``) and the plan has no batch
    axes. ``cache`` is the KV cache's layout: the batch over the batch
    axes, whole over the rest (``sharding.lm_cache_specs`` under
    "tp_fsdp").
    """

    def __init__(self, cfg, mesh, moe_shardings=None, *, batch=None):
        from repro_torch.distributed.sharding import (P, lm_param_specs,
                                                      lm_global_shapes)
        from repro_torch.launch.mesh import (all_axes, axes_size, data_axes,
                                             model_axis)
        from repro_torch.tree import flatten_with_path

        self.cfg, self.mesh = cfg, mesh
        self.strategy = _strategy(cfg)
        shape = mesh_shape(mesh)
        if self.strategy == "fsdp":
            self.mdl, self.batch_axes = None, tuple(all_axes(mesh))
        else:
            self.mdl = model_axis(mesh)
            self.batch_axes = tuple(data_axes(mesh))
        if batch is not None and int(batch) % axes_size(mesh,
                                                         self.batch_axes):
            self.batch_axes = ()
        dp = self.batch_axes or None
        self.cache = {"k": P(None, dp, None, None, None),
                      "v": P(None, dp, None, None, None),
                      "pos": P(dp, None), "index": P()}
        self.act = residual_spec(cfg, mesh)
        self.m = shape[self.mdl] if self.mdl else 1
        self.spec_of = dict(flatten_with_path(lm_param_specs(
            cfg, mesh, lm_global_shapes(cfg), strategy=self.strategy)))
        self.loss_axes = self.batch_axes + ((self.mdl,) if self.mdl else ())

        def split(name, dim):
            s = self.spec_of[f"['layers']/['{name}']"]
            return self.mdl is not None and _axes(s[dim]) == (self.mdl,)

        # this data rank's tokens at every position: the layout of the
        # MoE layer's tokens (the reference's "tokens" P(dp, None)) and of
        # the blocks that run on every model rank alike
        self.tokens = P(self.batch_axes or None, None, None)
        self.col_split = {k: split(k, 2) for k in ("wq", "wk", "wv")}
        if all(self.col_split.values()):
            whole = (cfg.n_heads % self.m == 0
                     and cfg.n_kv_heads % self.m == 0)
            self.attn = "heads" if whole else "gathered"
        elif any(self.col_split.values()):
            self.attn = "gathered"
        else:
            self.attn = "replicated"
        self.wo_split = split("wo", 1)
        self.moe = self.moe_shardings = None
        if cfg.moe:
            self._moe_mode(moe_shardings, split)
        else:
            self.ffn = "split" if split("w_gate", 2) else "replicated"
        head = "['embed']" if cfg.tie_embeddings else "['lm_head']"
        self.head = ("vocab" if not cfg.tie_embeddings
                     and _axes(self.spec_of[head][1]) == (self.mdl,)
                     and self.mdl is not None else "seq")
        self.gathers, self.grad_axes = {}, {}
        for path, spec in self.spec_of.items():
            lead = 1 if path.startswith("['layers']") else 0
            self.gathers[path] = [
                (i - lead, _axes(e)) for i, e in enumerate(spec)
                if i >= lead and e is not None and _axes(e) != (self.mdl,)]
            self.grad_axes[path] = self._grad_axes(path, spec)
        self._groups = {}

    def group(self, axes):
        """The process group along ``axes`` (made once per plan)."""
        axes = _axes(axes)
        if axes not in self._groups:
            self._groups[axes] = axes_group(self.mesh, axes)
        return self._groups[axes]

    @property
    def model_group(self):
        return self.group(self.mdl) if self.mdl else None

    @property
    def batch_group(self):
        return self.group(self.batch_axes)

    @property
    def loss_group(self):
        return self.group(self.loss_axes)

    def _moe_mode(self, moe_shardings, split) -> None:
        cfg, mesh = self.cfg, self.mesh
        if isinstance(moe_shardings, dict) and "ep_mesh" in moe_shardings:
            self.moe = "ep"
        elif is_tp_expert_dict(moe_shardings) or self.mdl is None:
            self.moe = "tp"
        else:
            self.moe = "ep" if cfg.n_experts % self.m == 0 else "tp"
        if self.moe == "ep":
            if not split("w_gate", 1):
                raise ValueError(f"expert parallelism needs {cfg.n_experts}"
                                 f" experts split over {self.m} ranks")
            self.moe_shardings = {"ep_mesh": mesh, "mdl": self.mdl,
                                  "dp": self.batch_axes}
            self.ffn = "replicated"
            return
        if self.m > 1 and split("w_gate", 1):
            raise ValueError(f"the rules split {cfg.n_experts} experts over"
                             f" {self.m} model ranks (expert parallelism);"
                             " TP inside the experts needs them whole")
        # the capacity dimension over the batch axes, d_ff over `model`
        self.moe_shardings = tp_expert_dict(mesh, self.batch_axes, self.mdl)
        # d_ff split over `model` (over one model rank: whole, and still
        # run through the Megatron pair, as transformer._tp_experts does)
        one = self.mdl is not None and self.m == 1
        self.ffn = "split" if split("w_gate", 3) or one else "replicated"

    def _model_split(self, name: str) -> bool:
        """Whether a leaf replicated over `model` is used on a different
        part of the work on each model rank (its gradients then sum over
        `model`), rather than on the same work on every one."""
        if name in ("embed", "lm_head", "attn_norm", "ffn_norm",
                    "final_norm"):
            return True      # the sequence split (or the vocab head's)
        if name in ("q_norm", "k_norm"):
            return self.attn == "heads"
        return False         # redundant: the same work on every rank

    def _grad_axes(self, path: str, spec) -> tuple:
        used = _axes_of(spec)
        axes = [a for a in self.batch_axes if a not in used]
        if (self.mdl and self.mdl not in used
                and self._model_split(_leaf_name(path))):
            axes.append(self.mdl)
        names = axis_names(self.mesh)
        return tuple(a for a in names if a in axes)

    def layer_gathers(self) -> dict:
        """{leaf name: [(dim, axes), ...]} for one layer's leaves."""
        return {_leaf_name(p): g for p, g in self.gathers.items()
                if p.startswith("['layers']")}

    def gather_leaf(self, x, gathers):
        """A leaf's block gathered over its ``fs`` axes (ZeRO-3)."""
        for dim, axes in gathers:
            x = gather(x, dim, self.group(axes))
        return x

    def predicted_counts(self, seq: int, xent_chunk: int, *,
                         remat: bool = True, step: bool = False) -> dict:
        """The collectives (``COUNTS``' keys) one value-and-grad of the
        loss issues at sequence length ``seq``, by this plan (and, with
        ``step``, the train step's clipping norm). Each layer's forward
        collectives run again in the recompute under ``remat``, and each
        vocab-parallel cross-entropy chunk's always (checkpoints holding
        collectives replay the whole region: ``checkpoint_early_stop``
        is off there)."""
        cfg, m1 = self.cfg, self.m > 1
        fwd, bwd = collections.Counter(), collections.Counter()
        ag, rs, ar = "all_gather", "reduce_scatter", "all_reduce"
        g = sum(len(v) for v in self.layer_gathers().values())
        fwd[ag] += g
        bwd[rs] += g
        if self.attn == "heads":
            fwd.update([ag, rs])
            bwd.update([rs, ag])
        else:
            fwd[ag] += m1 + sum(self.col_split.values())
            bwd[ar] += any(self.col_split.values())
            if self.wo_split:
                fwd[rs] += 1
                bwd[ag] += 2
            else:
                bwd[ag] += m1
        if cfg.moe:
            fwd[ag] += m1
            bwd[ag] += m1
            if self.moe == "ep":
                fwd[ar] += 1
                bwd[ar] += 2
            else:
                fwd[ag] += self.moe_shardings["tokens"].spec[0] is not None
                fwd[ar] += self.ffn == "split"
                bwd[ar] += self.ffn == "split"
        elif self.ffn == "split":
            fwd.update([ag, rs])
            bwd.update([rs, ag])
        else:
            fwd[ag] += m1
            bwd[ag] += m1
        out = collections.Counter()
        for k in set(fwd) | set(bwd):
            out[k] = cfg.n_layers * (fwd[k] * (2 if remat else 1) + bwd[k])
        head = "['embed']" if cfg.tie_embeddings else "['lm_head']"
        for key in ("['embed']", head):
            out[ag] += len(self.gathers[key])
            out[rs] += len(self.gathers[key])
        if self.head == "vocab":
            out[ag] += 1
            out[rs] += 1
            out[ar] += 2 * 3 * -(-seq // xent_chunk)
        out[ar] += 2 + len({a for a in self.grad_axes.values() if a})
        if step:
            names = axis_names(self.mesh)
            out[ar] += len({tuple(a for a in names if a in _axes_of(s))
                            for s in self.spec_of.values()} - {()})
        return {k: v for k, v in out.items() if v}

    def seq_block(self, x, dim: int = 1):
        """This model rank's block of the sequence (no gradient path to
        the other blocks: tokens and labels)."""
        if self.mdl is None:
            return x
        n, me = self.m, dist.get_rank(self.model_group)
        k = x.shape[dim] // n
        if x.shape[dim] % n:
            raise ValueError(f"sequence of {x.shape[dim]} does not divide "
                             f"over {n} model ranks")
        return x.narrow(dim, me * k, k)

    def reduce_grads(self, grads):
        """Each gradient leaf summed over its ``grad_axes``: one
        all-reduce of one flat buffer per set of axes."""
        from repro_torch.tree import flatten_with_path, tree_unflatten

        flat = flatten_with_path(grads)
        out = [g for _, g in flat]
        by_axes = collections.defaultdict(list)
        for i, (path, _) in enumerate(flat):
            if self.grad_axes[path]:
                by_axes[self.grad_axes[path]].append(i)
        for axes, idx in by_axes.items():
            buf = torch.cat([out[i].reshape(-1) for i in idx])
            buf = _all_reduce(buf, self.group(axes))
            parts = torch.split(buf, [out[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                out[i] = part.reshape(out[i].shape)
        return tree_unflatten(grads, out)

    def norm_reduce(self, tree):
        """``optimizer.global_norm``'s reduction of per-leaf sums of
        squares: each block's sum added over the axes its leaf is split
        over, so every distinct block counts once and a replicated leaf
        once."""
        from repro_torch.tree import flatten_with_path

        paths = [p for p, _ in flatten_with_path(tree)]

        def reduce(sq: list) -> list:
            out = list(sq)
            by_axes = collections.defaultdict(list)
            for i, p in enumerate(paths):
                used = _axes_of(self.spec_of[p])
                if used:
                    by_axes[tuple(a for a in axis_names(self.mesh)
                                  if a in used)].append(i)
            for axes, idx in by_axes.items():
                buf = _all_reduce(torch.stack([out[i] for i in idx]),
                                  self.group(axes))
                for k, i in enumerate(idx):
                    out[i] = buf[k]
            return out
        return reduce
