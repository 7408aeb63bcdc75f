"""Expert-parallel MoE dispatch on ``torch.distributed`` (port of
``repro.models.moe_ep``).

Layout: tokens are data-sharded and REPLICATED across the model axis;
experts are sharded across the model axis (E/|model| per rank). Each
model rank therefore already holds every token it could need — it simply
compacts the tokens routed to ITS experts into a local capacity buffer
(plain local gather, no all-to-all), runs its experts, scatters back,
and one all-reduce over the model group combines the partial outputs
(each token's experts live on exactly `top_k` ranks).

The body is the port's ``moe_ffn`` arithmetic (``transformer.moe_route``,
``moe_slots``, ``moe_experts``) restricted to this rank's experts, so on
one rank it computes ``moe_ffn``'s bits.

Gradients follow the reference's ``shard_map`` (replicated inputs,
output replicated over the model axis): the output's all-reduce passes
its cotangent through unchanged (each model rank holds the whole,
replicated cotangent; summing it again would scale the experts'
gradients by |model|), and the token activations and the router, which
every model rank uses, sum their cotangents over the model group (the
Megatron pair, ``distributed.tp.copy_to`` / ``sum_over``). A caller's
data-parallel all-reduce then completes every gradient.

Expert stacks sharded over the data axes too (the reference's rule
``P(mdl, fs, None)``, ZeRO-3) are gathered over them on entry, as the
reference's ``shard_map`` ``in_specs`` ``P(mdl, None, None)`` forces:
the FSDP gather (``distributed.tp.gather``), whose backward
reduce-scatters the experts' gradients, summing them over the data
group.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.distributed.tp import copy_to, gather, sum_over
from repro_torch.launch.mesh import axes_group, mesh_shape

from .transformer import moe_experts, moe_route, moe_slots


def moe_ffn_ep(x, p, cfg, mesh, *, dp_axes, mdl_axis,
               capacity: Optional[int] = None):
    """x [t_local, D] this rank's tokens (the data shard along
    ``dp_axes``, replicated over ``mdl_axis``) -> [t_local, D].

    ``p`` holds the replicated ``router`` [D, E] and this rank's slice
    of the experts, ``w_*`` [E/|model|, ...]: experts ``[me * e_local,
    (me + 1) * e_local)`` for model coordinate ``me``. ``capacity``
    defaults to the reference's ``ceil(t_local * k / E *
    capacity_factor)``."""
    t, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    shape = mesh_shape(mesh)
    n_mdl = int(shape[mdl_axis])
    e_local = e // n_mdl
    if p["w_gate"].shape[0] != e_local:
        raise ValueError(f"expert slice of {p['w_gate'].shape[0]} experts; "
                         f"{e} experts over {n_mdl} model ranks hold "
                         f"{e_local} each")
    if not set(dp_axes) <= set(shape):
        raise ValueError(f"data axes {dp_axes} not on the mesh {shape}")
    if capacity is None:
        capacity = int(np.ceil(t * k / e * cfg.capacity_factor))
    c = max(capacity, 1)
    group = mesh.get_group(mdl_axis)
    me = mesh.get_local_rank(mdl_axis)
    p = dict(p, **_gathered_experts(p, cfg, mesh, tuple(dp_axes)))

    x = copy_to(x, group)
    router = copy_to(p["router"], group)
    topv, topi = moe_route(x, router, k)
    slot_tok, slot_w = moe_slots(topv, topi, c, me * e_local, e_local)
    out = moe_experts(x, p, slot_tok, slot_w)
    # each token was processed by top_k experts spread over ranks
    return sum_over(out, group)


def _gathered_experts(p, cfg, mesh, dp_axes) -> dict:
    """The expert stacks with their second dimension (d_model of
    ``w_gate``/``w_up``, d_ff of ``w_down``) whole: a block of it over
    the data axes is gathered over them; a whole one (the LM's layer
    gathers its leaves) is taken as it is."""
    full = {"w_gate": cfg.d_model, "w_up": cfg.d_model, "w_down": cfg.d_ff}
    n = int(np.prod([mesh_shape(mesh)[a] for a in dp_axes]))
    out = {}
    for key, want in full.items():
        have = p[key].shape[1]
        if have == want:
            continue
        if have * n != want:
            raise ValueError(f"{key} holds {have} of {want} rows of its "
                             f"second dimension; {n} data ranks hold "
                             f"{want // n} each")
        out[key] = gather(p[key], 1, axes_group(mesh, dp_axes))
    return out
