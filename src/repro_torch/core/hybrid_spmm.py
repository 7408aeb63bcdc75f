"""The tri-engine heterogeneous SpMM executor (paper §IV-A/§IV-D/§IV-E).

Port of ``repro.core.hybrid_spmm``. Computes ``Y = A @ B`` where A is a
TriPartition, dispatching each component to its engine:

  dense tiles -> per-tile T×T products, summed over tile_row (one
                 kernel on the ``cuda`` backend)
  ELL units   -> gather + FMA over the ragged unit array
                 (``ell_dispatch="ragged"``), or per fixed-K bucket
                 (``"fused"``/``"loop"``, the per-K A/B dispatches); on
                 the ``cuda`` backend the kernels also sum the unit rows
                 onto output rows and add them onto the dense engine's
                 rows (one launch a layer)
  COO residual-> take + segment sum        (flexible engine; on the
                 ``cuda`` backend one kernel that also sums the
                 messages onto rows and adds them onto the dense + ELL
                 rows, one launch a layer)

The three partial products add as ``(dense + ell) + coo`` on both
backends.

Types, as in the reference: B is float32 or bfloat16 (anything else is
taken as float32). With a bfloat16 B the dense tiles are rounded to
bfloat16, their products summed in float32 and the dense engine's rows
rounded to bfloat16; the ELL and COO products are taken in float32 from
the upcast operands; the three rows are added in float32 and the result
is rounded to bfloat16. A float32 B runs in float32 throughout. The GCN
layers multiply X·W in the type of X and W promoted, as the reference's
``x @ w``.

Two backends:
  * ``torch`` — plain PyTorch (mirrors the reference's ``xla``).
  * ``cuda``  — dense tiles, ELL units and the COO residual through the
                hand-written CUDA kernels in ``repro_torch.kernels``
                (mirrors ``pallas``, whose COO engine is plain JAX);
                on CPU tensors the kernel wrappers run their plain
                versions.

Every function accepts a leading group axis ``G`` on B and on all
partition leaves (the ``serve_group`` path), and a ``ReductionPlan``
(``repro_torch.core.formats.reduction_plan``) that fixes the order of
every sum onto output rows; without one, the plan is built on the fly
from the partition on the host.

Gradients. ``hybrid_spmm``, ``gcn_layer`` and ``gcn_forward`` can be
differentiated on both backends: the product goes through
``HybridSpmmFn``, whose backward is ``dB = Aᵀ·dY`` computed by the same
executor over Aᵀ's own tri-partition (built once per partition by
``partition.transpose_partition``, cached in ``ADJOINTS``; A's own
partition and plan where A is symmetric), on the same backend and ELL
dispatch. On the ``cuda`` backend the backward therefore runs the hand
kernels, and every sum in it follows a ``ReductionPlan``: no atomics,
so a training step repeats bit for bit. A grouped partition (G > 1)
runs each member through ``HybridSpmmFn`` with its own plan when a
gradient is required, and stacks the results: each member's result and
gradient have the bits of that member run alone.
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (bsr_spmm_rows_ref, ell_spmm_ref,
                                     ragged_ell_spmm_ref)

from .formats import (IdentityCache, PartitionMeta, ReductionPlan,
                      TriPartition, b_tiles_of, ell_buckets, pad_b_to_tiles,
                      partition_to, plan_to, reduction_plan,
                      scatter_ell_partials, segment_sum)
from .partition import transpose_partition

BACKENDS = ("cuda", "torch")


def dense_tiles_matmul(part: TriPartition, b: torch.Tensor,
                       meta: PartitionMeta, plan: ReductionPlan
                       ) -> torch.Tensor:
    """Dense-engine partial product, B [G, N, F] -> [G, nrt*T, F] float32
    (rounded to bfloat16 where B is: ``bsr_spmm_rows_ref``)."""
    g, _, f = b.shape
    T, nrt = meta.tile, meta.n_row_tiles
    if part.dense.tiles.shape[-3] == 0:
        return b.new_zeros((g, nrt * T, f), dtype=torch.float32)
    out = bsr_spmm_rows_ref(kops.dense_tiles_of(part, b),
                            part.dense.tile_col, b_tiles_of(b, meta),
                            plan.dense)                       # [G,nrt,T,F]
    return out.reshape(g, nrt * T, f)


def ell_matmul(part: TriPartition, b: torch.Tensor, meta: PartitionMeta,
               plan: ReductionPlan, *, dispatch: str = "ragged"
               ) -> torch.Tensor:
    """Sparse-engine partial product, [G, n_padded_rows, F], with the
    reference's structure.

    ``"ragged"`` runs one masked Kmax pass over the concatenated unit
    array (the reference's XLA mirror; the ``cuda`` backend's kernel runs
    each unit only to its band's K, the same bits for finite B);
    ``"fused"``/``"loop"`` run one fixed-K pass per bucket of
    ``meta.ell_segments``. The products are reduced onto rows at once
    (``"ragged"``, ``"fused"``, in the order of ``plan.ell``) or bucket by
    bucket into a running buffer (``"loop"``, as the reference's
    sequential scatters; its per-bucket plans are built from the buckets'
    rows).
    """
    kops.check_ell_dispatch(dispatch)
    g, _, f = b.shape
    if part.ell.cols.shape[-3] == 0:
        return b.new_zeros((g, meta.n_padded_rows, f), dtype=torch.float32)
    bt = b_tiles_of(b, meta)
    if dispatch == "ragged":
        prod = ragged_ell_spmm_ref(part.ell.cols, part.ell.vals,
                                   part.ell.tile_col, part.ell.unit_k, bt)
        return _scatter_all(part, prod, meta, plan)
    buckets = ell_buckets(part.ell, meta.ell_segments)
    prods = [ell_spmm_ref(bk.cols, bk.vals, bk.tile_col, bt)
             for bk in buckets]
    if dispatch == "fused":
        return _scatter_all(part, torch.cat(prods, dim=1), meta, plan)
    return scatter_ell_partials(
        [bk.rows.reshape(g, -1) for bk in buckets],
        [p.reshape(g, -1, f) for p in prods], meta)


def _scatter_all(part, prod, meta, plan):
    g, u, r, f = prod.shape
    return scatter_ell_partials(part.ell.rows.reshape(g, u * r),
                                prod.reshape(g, u * r, f), meta,
                                plan=plan.ell)


def coo_matmul(part: TriPartition, b: torch.Tensor, meta: PartitionMeta,
               plan: ReductionPlan) -> torch.Tensor:
    """Flexible-engine partial product (row-wise product SpMM),
    [G, nrt*T, F] float32 (products of the upcast operands)."""
    g, _, f = b.shape
    nnz = part.coo.vals.shape[-1]
    if nnz == 0:
        return b.new_zeros((g, meta.n_padded_rows, f), dtype=torch.float32)
    bp = pad_b_to_tiles(b, meta)
    idx = part.coo.cols.long()[..., None].expand(g, nnz, f)
    msgs = (part.coo.vals[..., None].float()
            * torch.gather(bp, 1, idx).float())             # [G,nnz,F]
    out = segment_sum(msgs.reshape(g * nnz, f), plan.coo)
    return out.reshape(g, meta.n_padded_rows, f)


def _grouped(part: TriPartition, b, plan, meta, dev):
    """Place everything on ``dev`` and give it a leading group axis.

    Returns (part, b, plan, squeeze): ``squeeze`` says the caller passed
    one unstacked graph, whose result drops the group axis again.
    """
    part = partition_to(part, dev)
    b = as_operand(b).to(dev)
    if plan is None:
        plan = reduction_plan(part, meta)
    plan = plan_to(plan, dev)
    squeeze = b.dim() == 2
    if squeeze:
        part = TriPartition(*(type(c)(*(a[None] for a in c)) for c in part))
        b = b[None]
    return part, b, plan, squeeze


def as_operand(x) -> torch.Tensor:
    """``x`` as a tensor of one of the types the executor computes in:
    bfloat16 stays bfloat16, anything else becomes float32."""
    x = torch.as_tensor(x)
    return x if x.dtype == torch.bfloat16 else x.float()


# The width key of a tuning table entry that applies at every width.
EVERY_WIDTH = 0


def tune_at(ell_tune, f) -> dict:
    """The ragged kernel's tuned config for a launch of width ``f``.

    ``ell_tune`` is None, one config (any of "w", "vec", "kc",
    "threads", "max_bands") for every width, or a tuning table {width:
    config} (an executor's, one config per width it was tuned at),
    where ``EVERY_WIDTH`` (0) covers
    the widths without their own entry. ``f`` None reads that entry.
    Returns the config ({} = the defaults)."""
    if not ell_tune:
        return {}
    if not all(isinstance(k, int) for k in ell_tune):
        return dict(ell_tune)
    cfg = ell_tune.get(int(f)) if f is not None else None
    return dict(cfg or ell_tune.get(EVERY_WIDTH) or {})


def _stacked(part: TriPartition) -> bool:
    return part.dense.tiles.ndim == 4


def _member(part: TriPartition, g: int, axis: bool = False) -> TriPartition:
    """Member ``g`` of a grouped partition: unstacked, or with a group
    axis of 1 (``axis``)."""
    at = slice(g, g + 1) if axis else g
    return TriPartition(*(type(c)(*(a[at] for a in c)) for c in part))


class _Adjoint:
    """Aᵀ's tri-partition for the backward, placed on the device of the
    first backward with a group axis of 1, and its reduction plan (one
    placed copy, placed anew if a later backward runs elsewhere).
    ``symmetric``: A equals Aᵀ, and the forward's own partition and plan
    serve."""

    def __init__(self, part_t, meta_t, symmetric: bool):
        self.meta = meta_t
        self.symmetric = symmetric
        self._host = None if symmetric else part_t
        self._dev, self._placed = None, None

    def on(self, dev):
        dev = torch.device(dev)
        if self._dev != dev:
            part = partition_to(self._host, dev)
            self._dev, self._placed = dev, (
                TriPartition(*(type(c)(*(a[None] for a in c)) for c in part)),
                reduction_plan(self._host, self.meta, device=dev))
        return self._placed


class AdjointCache:
    """Aᵀ's partition per partition, built at the first backward that
    needs it and kept while the partition's leaves live (an
    ``IdentityCache`` keyed on the leaves as the caller passed them,
    numpy arrays or tensors). ``stats()`` counts the symmetry checks, the
    partitions of Aᵀ built (a symmetric A builds none) and the seconds
    both took on the host.
    """

    def __init__(self):
        self._cache = IdentityCache()
        self.checks = 0
        self.builds = 0
        self.build_s = 0.0

    def get(self, part: TriPartition, meta: PartitionMeta,
            member: int = None) -> _Adjoint:
        """Aᵀ of ``part``, or of its member ``member`` where ``part`` is
        grouped (keyed on the grouped leaves)."""
        leaves = tuple(a for comp in part for a in comp)
        one = part if member is None else _member(part, member)
        return self._cache.get(leaves, (meta, member),
                               lambda: self._build(one, meta))

    def _build(self, part, meta) -> _Adjoint:
        t0 = time.perf_counter()
        part_t, meta_t = transpose_partition(part, meta)
        symmetric = part_t is part
        self.checks += 1
        self.builds += not symmetric
        self.build_s += time.perf_counter() - t0
        return _Adjoint(part_t, meta_t, symmetric)

    def stats(self) -> dict:
        return {"checks": self.checks, "builds": self.builds,
                "build_s": self.build_s, "cached": len(self._cache)}


ADJOINTS = AdjointCache()

# the reduction plan of each member of a grouped partition that a
# gradient goes through, keyed on the caller's grouped leaves
MEMBER_PLANS = IdentityCache()


def _member_plan(source: TriPartition, meta: PartitionMeta, g: int, dev):
    leaves = tuple(a for comp in source for a in comp)
    return MEMBER_PLANS.get(leaves, (meta, g, str(dev)),
                            lambda: reduction_plan(_member(source, g), meta,
                                                   device=dev))


class HybridSpmmFn(torch.autograd.Function):
    """``Y = A·B`` through the tri-engine executor, differentiable in B.

    Forward: the executor (``_hybrid``) with grad off. Backward:
    ``dB = Aᵀ·dY`` through ``_hybrid`` over Aᵀ's partition (``ADJOINTS``,
    keyed on ``source``, the caller's unstacked partition, or its member
    ``member`` where ``source`` is grouped), on the same backend, ELL
    dispatch and launch tuning: on ``cuda`` the dense and
    ELL row kernels, their sums by plan. dY has the forward's width, so
    a per-width tuning table (``tune_at``) gives the backward's launches
    the forward's config. A, its leaves, the meta and the plan get no
    gradient.
    """

    @staticmethod
    def forward(ctx, b, source, member, part, meta, plan, backend,
                ell_dispatch, ell_tune):
        ctx.source, ctx.member = source, member
        ctx.meta, ctx.part, ctx.plan = meta, part, plan
        ctx.cfg = (backend, ell_dispatch, ell_tune)
        ctx.b_rows = b.shape[-2]
        return _hybrid(part, b, meta, plan, backend, ell_dispatch, ell_tune)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        adj = ADJOINTS.get(ctx.source, ctx.meta, ctx.member)
        if adj.symmetric:
            part_t, plan_t = ctx.part, ctx.plan
        else:
            part_t, plan_t = adj.on(dy.device)
        db = _hybrid(part_t, dy.contiguous(), adj.meta, plan_t, *ctx.cfg)
        n = ctx.b_rows
        if db.shape[-2] >= n:
            db = db[:, :n]
        else:   # B rows past A's columns meet no entry of A
            db = torch.nn.functional.pad(db, (0, 0, 0, n - db.shape[-2]))
        return (db,) + (None,) * 8


def _product(source, part, b, meta, plan, backend, ell_dispatch,
             ell_tune=None, chain=None):
    """``_hybrid`` through ``HybridSpmmFn`` when B needs a gradient;
    ``source`` is the caller's partition. A grouped one runs each
    member alone (its own group axis of 1 and plan) and stacks the
    results: the bits of each member's own call. The gradient is float32
    only: a bfloat16 B that needs one raises (training runs in float32).
    ``chain`` (an ``obs.device.DeviceChain``) is marked without a
    gradient only."""
    if not (torch.is_grad_enabled() and b.requires_grad):
        return _hybrid(part, b, meta, plan, backend, ell_dispatch, ell_tune,
                       chain)
    if b.dtype != torch.float32:
        raise NotImplementedError(
            f"hybrid_spmm differentiates a float32 B only, not {b.dtype}: "
            "train in float32 (bfloat16 runs without gradients)")
    if not _stacked(source):
        return HybridSpmmFn.apply(b, source, None, part, meta, plan, backend,
                                  ell_dispatch, ell_tune)
    return torch.stack([
        HybridSpmmFn.apply(b[g:g + 1], source, g, _member(part, g, True),
                           meta, _member_plan(source, meta, g, b.device),
                           backend, ell_dispatch, ell_tune)[0]
        for g in range(b.shape[0])])


def hybrid_spmm(part: TriPartition, b, *, meta: PartitionMeta,
                backend: str = "cuda", ell_dispatch: str = "ragged",
                plan: ReductionPlan = None, ell_tune: dict = None,
                device="cuda") -> torch.Tensor:
    """Y = A @ B via the three engines. Returns [(G,) n_rows, F] on
    ``device``.

    ``ell_tune`` optionally carries an autotuned ragged-kernel launch
    shape, one config or a table by width (``tune_at``; ``cuda``
    backend: the plain ``torch`` backend has no launch knobs); tuned
    outputs are bitwise-equal to the defaults.
    """
    dev = resolve_device(device)
    source = part
    part, b, plan, squeeze = _grouped(part, b, plan, meta, dev)
    y = _product(source, part, b, meta, plan, backend, ell_dispatch,
                 ell_tune)
    return y[0] if squeeze else y


def _hybrid(part, b, meta, plan, backend, ell_dispatch, ell_tune=None,
            chain=None):
    """The three engines; ``chain`` marks the end of each engine's work
    (``dense``, ``ell``, ``coo``)."""
    if backend == "cuda":
        yd = kops.dense_tiles_matmul(part, b, meta, plan)
        if chain is not None:
            chain.mark("dense")
        y = kops.ell_matmul(part, b, meta, plan, yd, dispatch=ell_dispatch,
                            ell_tune=tune_at(ell_tune, b.shape[-1]) or None)
    elif backend == "torch":
        yd = dense_tiles_matmul(part, b, meta, plan)
        if chain is not None:
            chain.mark("dense")
        y = yd + ell_matmul(part, b, meta, plan, dispatch=ell_dispatch)
    else:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    if chain is not None:
        chain.mark("ell")
    if backend == "cuda":
        y = kops.coo_matmul(part, b, meta, plan, y)
    else:
        y = y + coo_matmul(part, b, meta, plan)
    if chain is not None:
        chain.mark("coo")
    return y[:, : meta.n_rows].to(b.dtype)


def hybrid_spmm_ref(a_dense, b):
    """Oracle: plain dense matmul."""
    return a_dense @ b


# ---------------------------------------------------------------------------
# Combination-first chained SpMM with intra-layer pipelining (paper §IV-E).
# ---------------------------------------------------------------------------

def member_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X·W of a group, x [G, N, F] @ w [G or 1, F, H] -> [G, N, H]: one
    2-D ``torch.matmul`` per member, so member g's product is the same
    call (same M, N, K) at every group size and its bits do not depend
    on G. One batched product would let cuBLAS pick another kernel for
    another batch count, and a request re-dispatched in a smaller group
    (a chaos batch-mate, a 1-request ``infer``) would change bits.

    Where autograd records (grad on, an input requiring grad) the
    members' products are stacked instead of written through ``out=``,
    which autograd refuses: the same 2-D calls, so the same bits."""
    def w_of(g):
        return w[g if w.shape[0] > 1 else 0]

    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return torch.stack([torch.matmul(x[g], w_of(g))
                            for g in range(x.shape[0])])
    out = x.new_empty(x.shape[:-1] + (w.shape[-1],))
    for g in range(x.shape[0]):
        torch.matmul(x[g], w_of(g), out=out[g])
    return out


def _layer(source, part, x, w, meta, plan, backend, block_cols, activation,
           ell_dispatch, ell_tune=None, chain=None):
    """One GCN layer on grouped tensors: x [G, N, F_in], w [G, F_in, H];
    X·W in the promoted type of the two. ``chain`` marks the end of each
    X·W (``xw``) and of the engines; the caller marks the layer's
    ``out``."""
    h = w.shape[-1]
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)

    def xw(wb):
        y = member_matmul(x, wb)
        if chain is not None:
            chain.mark("xw")
        return y

    if block_cols and block_cols < h:
        nblk = -(-h // block_cols)
        wp = torch.nn.functional.pad(w, (0, nblk * block_cols - h))
        outs = [_product(source, part, xw(
                    wp[..., i * block_cols:(i + 1) * block_cols]),
                    meta, plan, backend, ell_dispatch, ell_tune, chain)
                for i in range(nblk)]
        y = torch.cat(outs, dim=-1)[..., :h]
    else:
        y = _product(source, part, xw(w), meta, plan, backend,
                     ell_dispatch, ell_tune, chain)
    return activation(y) if activation is not None else y


def gcn_layer(part: TriPartition, x, w, *, meta: PartitionMeta,
              backend: str = "cuda", block_cols: int = 0, activation=None,
              ell_dispatch: str = "ragged", plan: ReductionPlan = None,
              ell_tune: dict = None, device="cuda") -> torch.Tensor:
    """One GCN layer  sigma(A @ (X @ W))  in combination-first order.

    ``block_cols > 0`` processes W's output columns in blocks, emitting
    ``A @ (X @ W[:, blk])`` per block (the paper's fine-grained
    pipelining). X·W is plain ``torch.matmul``, as the reference leaves
    it to XLA: one 2-D product per group member (``member_matmul``).
    ``ell_tune`` as for ``hybrid_spmm``.
    """
    dev = resolve_device(device)
    source = part
    part, x, plan, squeeze = _grouped(part, x, plan, meta, dev)
    w = as_operand(w).to(dev)
    y = _layer(source, part, x, w if w.dim() == 3 else w[None], meta, plan,
               backend, block_cols, activation, ell_dispatch, ell_tune)
    return y[0] if squeeze else y


def gcn_forward(part: TriPartition, x, weights, *, meta: PartitionMeta,
                backend: str = "cuda", block_cols: int = 0,
                ell_dispatch: str = "ragged", plan: ReductionPlan = None,
                ell_tune: dict = None, device="cuda",
                chain=None) -> torch.Tensor:
    """The paper's 2-layer vanilla GCN:  softmax-free inference logits
    X2 = A·relu(A·X·W1)·W2   (activation on hidden layer only).

    With a leading group axis on ``x``, the partition leaves and the
    weights, the whole group runs with one launch of each kernel per
    layer, and each member's logits are bitwise-equal to its own G = 1
    forward. ``ell_tune`` as for ``hybrid_spmm``.

    Differentiable in ``x`` and ``weights`` (``HybridSpmmFn``): the
    reference's ``jax.value_and_grad`` of this forward; a group's
    members one by one, each with the bits of its own G = 1 call. X·W's
    gradients are ``torch.matmul``'s own. In float32 only: bfloat16
    inputs that need a gradient raise ``NotImplementedError``.

    ``chain`` (an ``obs.device.DeviceChain``, the engine's while a
    tracer is on) is marked at each engine boundary of each layer and
    after each layer but the last, whose ``out`` the caller marks once
    it has unpadded the logits.
    """
    dev = resolve_device(device)
    source = part
    part, h, plan, squeeze = _grouped(part, x, plan, meta, dev)
    for i, w in enumerate(weights):
        w = as_operand(w).to(dev)
        last = i == len(weights) - 1
        act = None if last else torch.relu
        if chain is not None:
            chain.layer = i
        h = _layer(source, part, h, w if w.dim() == 3 else w[None], meta,
                   plan, backend, block_cols, act, ell_dispatch, ell_tune,
                   chain)
        if chain is not None and not last:
            chain.mark("out")
    return h[0] if squeeze else h
