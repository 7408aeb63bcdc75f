"""What a step does on one rank, counted op by op: FLOPs, bytes,
collectives and peak live bytes (the port's counterpart of
``repro.analysis.hlo``).

The reference reads a compiled XLA program: FLOPs and bytes from its
cost analysis, collectives parsed from its HLO text. An eager PyTorch
step has no compiled program, so ``OpCounter`` (a ``TorchDispatchMode``)
watches each aten op the step dispatches, on real tensors or on the
dry-run's fake ones (``launch/dryrun.py``):

- FLOPs: of matrix products, convolutions and attention by
  ``torch.utils.flop_counter``'s formulas (and ``mv``, ``dot``), split
  by the dtype of the product's operands (``flops_by_dtype``); of
  pointwise arithmetic (not ``clone``, a copy), one per output element,
  and of reductions, one per input element (``pointwise_flops``), as
  XLA's cost analysis counts elementwise work;
- bytes as each op's input plus output ``nbytes``; views and aliases
  move nothing and are skipped, as are allocations (``empty``) and the
  collectives (their traffic is ``collective_summary``'s);
- each c10d collective as its c10d name, dtype, result shapes and the
  global ranks of its group (``Recorded``), mapped to the reference's
  kinds by ``parse_collectives``;
- the peak of the bytes held by live storages, the step's arguments
  included (``track``), and host constants made tensors under fake
  tensors (``lift_fresh``: a host plan, which a real run on the card
  copies to the device).

There is no fusion: every op reads its inputs from memory and writes its
outputs back, so ``bytes`` is an upper bound on a fused program's.

``count_pallas_calls`` is not ported: the launch pass
(``analysis/static/launch_pass.py``) counts the port's kernel launches.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# ring-algorithm bytes-on-wire per participating device, as a multiple of
# the per-device result size (the reference's factors, ``hlo.py:50-59``)
_TRAFFIC_FACTOR = {
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}

# c10d op -> kind; each takes its result tensor(s) first. A
# point-to-point exchange counts once, at its send (the reference counts
# an async pair once, at its ``-start``); its receive is not counted.
_C10D = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}
_NOT_COUNTED = {"recv_", "barrier"}

# ops that move no bytes: metadata, allocations, aliases
_NO_TRAFFIC = {"prim.device", "aten.empty", "aten.empty_strided",
               "aten.empty_like", "aten.new_empty", "aten.new_empty_strided",
               "aten.detach", "aten.alias", "aten.sym_size",
               "aten.sym_stride", "aten.sym_numel",
               "aten.sym_storage_offset", "aten.is_same_size",
               "aten._local_scalar_dense", "aten.lift_fresh"}


def _vector_product(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.numel() if a.dim() == 1 else 2 * a.shape[0] * a.shape[1]


# matrix products: flop_counter's formulas, and matrix-vector products
_PRODUCTS = {**flop_registry, torch.ops.aten.mv: _vector_product,
             torch.ops.aten.dot: _vector_product}
# reductions without the ``reduction`` tag
_REDUCTIONS = {"aten.segment_reduce"}


class Recorded(NamedTuple):
    """One c10d collective as the counter saw it: ``op`` its c10d name,
    ``dtype`` and ``shapes`` of its result tensor(s), ``ranks`` the
    global ranks of its group (of a send: this rank and its peer)."""
    op: str
    dtype: str
    shapes: tuple
    ranks: tuple


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    traffic_bytes: float
    line: str
    ranks: tuple = ()


def _nbytes(shape, dtype: str) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * getattr(torch, dtype).itemsize


def parse_collectives(records) -> list:
    """``CollectiveOp``s of recorded c10d ops: each with the reference's
    bytes, result bytes times the kind's traffic factor (for a
    reduce-scatter the result is the shard, ``hlo.py:96-97``)."""
    out = []
    for r in records:
        kind = _C10D[r.op]
        rb = sum(_nbytes(s, r.dtype) for s in r.shapes)
        line = (f"{kind} {r.dtype}{[list(s) for s in r.shapes]} over "
                f"{len(r.ranks)} ranks")
        out.append(CollectiveOp(kind, rb, rb * _TRAFFIC_FACTOR[kind], line,
                                tuple(r.ranks)))
    return out


def collective_summary(records) -> dict:
    ops = parse_collectives(records)
    by_kind = {}
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "bytes": 0.0})
        d["count"] += 1
        d["bytes"] += op.traffic_bytes
    total = sum(d["bytes"] for d in by_kind.values())
    return {"by_kind": by_kind, "total_traffic_bytes": total,
            "n_ops": len(ops)}


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _group_ranks(args) -> tuple:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue            # a ReduceOp
            return pg, tuple(dist.get_process_group_ranks(pg))
    raise ValueError("a c10d op without a process group")


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered (see the module's
    docstring). On fake tensors a loop written ``for i in tiles(n, x)``
    runs its first two iterations and is counted as all ``n``
    (``tiles``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_dtype = {}
        self.pointwise_flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.records = []
        self.replayed = 0           # loop iterations counted, not run
        self.live = 0
        self.peak = 0
        self._storages = {}

    # ------------------------------------------------------------ memory
    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live (the step's
        arguments, made before the counter was entered)."""
        for t in _tensors(tree):
            self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()

        def free(_, key=key, n=n, counter=weakref.ref(self)):
            c = counter()
            if c is not None and c._storages.pop(key, None) is not None:
                c.live -= n
        self._storages[key] = weakref.ref(st, free)
        self.live += n
        self.peak = max(self.peak, self.live)

    # ------------------------------------------------------------ counts
    def counts(self) -> dict:
        return dict(flops=self.flops,
                    flops_by_dtype=dict(self.flops_by_dtype),
                    pointwise_flops=self.pointwise_flops,
                    bytes=self.bytes, n_ops=self.n_ops,
                    collectives=list(self.records), peak_bytes=self.peak,
                    replayed=self.replayed)

    def _mark(self) -> tuple:
        return (self.flops, dict(self.flops_by_dtype), self.pointwise_flops,
                self.bytes, self.n_ops, len(self.records))

    def _repeat(self, mark: tuple, times: int) -> None:
        flops, by_dtype, pointwise, nbytes, n_ops, n_rec = mark
        self.flops += (self.flops - flops) * times
        self.pointwise_flops += (self.pointwise_flops - pointwise) * times
        for k, v in self.flops_by_dtype.items():
            self.flops_by_dtype[k] = v + (v - by_dtype.get(k, 0)) * times
        self.bytes += (self.bytes - nbytes) * times
        self.n_ops += (self.n_ops - n_ops) * times
        self.records += self.records[n_rec:] * times
        self.replayed += times

    def _replay(self, n: int):
        yield 0
        mark = self._mark()
        yield 1
        self._repeat(mark, n - 2)

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = f"{func.namespace}.{func._opname}"
        if func.namespace == "c10d":
            self.n_ops += 1
            self._collective(func._opname, args)
            return out
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        if name in _NO_TRAFFIC or _is_view(func):
            return out
        self.n_ops += 1
        ins = _tensors((args, kwargs))
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        formula = _PRODUCTS.get(func.overloadpacket)
        if formula is not None:
            # ``bmm(a, b, out_dtype)``: the formulas take shapes only
            f = int(formula(*(a for a in args
                              if not isinstance(a, torch.dtype)),
                            **kwargs, out_val=out))
            dt = str(ins[0].dtype).replace("torch.", "")
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) + f
        elif torch.Tag.pointwise in func.tags and name != "aten.clone":
            f = max((t.numel() for t in outs), default=0)
            self.pointwise_flops += f
        elif torch.Tag.reduction in func.tags or name in _REDUCTIONS:
            f = ins[0].numel() if ins else 0
            self.pointwise_flops += f
        else:
            return out
        self.flops += f
        return out

    def _collective(self, op: str, args) -> None:
        if op in _NOT_COUNTED:
            return
        if op not in _C10D:
            raise ValueError(f"c10d.{op} is not a counted collective")
        res = args[0]
        res = list(res) if isinstance(res, (list, tuple)) else [res]
        pg, ranks = _group_ranks(args)
        if op == "send":
            me = dist.get_rank()
            ranks = (me, dist.get_global_rank(pg, int(args[2])))
        dtype = str(res[0].dtype).replace("torch.", "")
        self.records.append(Recorded(op, dtype,
                                     tuple(tuple(t.shape) for t in res),
                                     ranks))


def tiles(n: int, like: torch.Tensor):
    """``range(n)`` for a loop whose iterations dispatch the same ops on
    tensors of the same shapes (the attention's tile loops). Under a
    counting ``OpCounter`` with ``like`` a fake tensor, the first two
    iterations run and the counter counts the second ``n - 1`` times
    (the first may allocate what later ones reuse; from the second on,
    each holds the same tensors alive, so the peak is reached): the
    loop's outputs are fake, so only their shapes matter, and those the
    iterations that ran give. On real tensors every iteration runs."""
    from torch._subclasses.fake_tensor import FakeTensor

    if n > 2 and isinstance(like, FakeTensor):
        for mode in _get_current_dispatch_mode_stack():
            if isinstance(mode, OpCounter):
                return mode._replay(n)
    return range(n)
