"""The models an ``Engine`` serves, bound to a graph at ``register``.

Each model says how a handle's requests find their executor, which
operands its executor takes beyond (part, x, weights, plan), how a
group stacks them, and what a handle keeps of its own; ``Engine`` calls
it without asking which model it is. ``MODELS`` maps ``register``'s
``model=`` to one:

  GCN  the paper's model: weights a list of [f_in, f_out]; the group key
       (shape class, f_in, weight shapes); ``ExecutorCache.gcn``.
  GAT  ``core.gat``: weights a list of ``GatLayer``, A + I's pattern in
       place of the graph's values; the key adds ``"gat"`` and the
       ``GatSpec``; ``ExecutorCache.gat``, which takes the handle's row
       lists (stacked over a group) as well.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.gat import (GatLayer, gat_spec, gat_weights, row_lists,
                                  row_lists_to, split_rows, stack_row_lists)
from repro_torch.kernels import _build


class Gcn:
    name = "gcn"

    def prepare(self, csr, weights, part_meta):
        """The CSR that ``register`` partitions."""
        return csr

    def fields(self, csr, weights, padded, pmeta, device) -> dict:
        """The handle's model-specific fields, its weights among them,
        built in ``register``'s place phase."""
        return {"weights": weights}

    def key(self, h, f_in: int, w_shapes: tuple) -> tuple:
        return (h.sclass, f_in, w_shapes)

    def executor(self, ex, key: tuple, batch=None):
        """The executor of ``key`` (``batch``: a stacked group's)."""
        return ex.gcn(*key) if batch is None else ex.gcn_batched(*key, batch)

    def operands(self, h) -> tuple:
        """A handle's operands after (part, x, weights, plan)."""
        return ()

    def stacked(self, hs, device) -> tuple:
        """``operands`` of the members ``hs`` stacked over the group."""
        return ()

    def repadded(self, h, device) -> None:
        """Rebuild what depends on the class after a retirement moved
        ``h`` (its ``padded_meta`` already the new class's)."""

    def span_args(self, h):
        """The ``register`` span's end arguments."""
        return None


class Gat(Gcn):
    name = "gat"

    def prepare(self, csr, weights, part_meta):
        if part_meta is not None:
            raise ValueError("model='gat' partitions the pattern itself: "
                             "no part_meta")
        if weights is None:
            raise ValueError("model='gat' needs its layers (weights=)")
        return csr._replace(data=np.ones_like(np.asarray(csr.data),
                                              dtype=np.float32))

    def fields(self, csr, weights, padded, pmeta, device) -> dict:
        """Weights (``gat_weights``), spec, pattern, row lists (host and
        placed) and split rows."""
        if pmeta.n_row_tiles != pmeta.n_col_tiles:
            raise ValueError("model='gat' needs a square graph (A + I)")
        layers = [lay if isinstance(lay, GatLayer) else GatLayer(**lay)
                  for lay in weights]
        spec = gat_spec(layers)
        if not set(spec.heads) <= set(_build.HEADS):
            raise ValueError(f"model='gat': {spec.heads} heads a layer; the "
                             f"kernels are built for {_build.HEADS}")
        pattern = (np.asarray(csr.indptr), np.asarray(csr.indices))
        host_rows = row_lists(*pattern, pmeta.n_padded_rows)
        return {"weights": gat_weights(layers), "gat": spec,
                "pattern": pattern, "host_rows": host_rows,
                "rows": row_lists_to(host_rows, device),
                "split_rows": split_rows(padded, pmeta)}

    def key(self, h, f_in: int, w_shapes: tuple) -> tuple:
        return (h.sclass, f_in, w_shapes, "gat", h.gat)

    def executor(self, ex, key: tuple, batch=None):
        sc, f_in, w_shapes, _, spec = key
        if batch is None:
            return ex.gat(sc, f_in, w_shapes, spec)
        return ex.gat_batched(sc, f_in, w_shapes, spec, batch)

    def operands(self, h) -> tuple:
        return (h.rows,)

    def stacked(self, hs, device) -> tuple:
        return (row_lists_to(stack_row_lists([h.host_rows for h in hs]),
                             device),)

    def repadded(self, h, device) -> None:
        h.host_rows = row_lists(*h.pattern, h.padded_meta.n_padded_rows)
        h.rows = row_lists_to(h.host_rows, device)

    def span_args(self, h):
        return {"split_rows_two": h.split_rows["two"],
                "split_rows_three": h.split_rows["three"]}


GCN, GAT = Gcn(), Gat()
MODELS = {m.name: m for m in (GCN, GAT)}
