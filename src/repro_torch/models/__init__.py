"""Model zoo (port of ``repro.models``): the shared blocks, the
message-passing GNNs, the geometric GNNs (DimeNet, NequIP and their
SO(3) machinery), the transformer family with its chunked attention
and its expert-parallel MoE layer, and the factorization machine."""
from . import (attention, common, dimenet, fm, gnn, moe_ep,  # noqa: F401
               nequip, so3, transformer)
