"""Model zoo (port of ``repro.models``): the shared blocks, the
message-passing GNNs, the geometric GNNs (DimeNet, NequIP and their
SO(3) machinery), the transformer family with its chunked attention,
and the factorization machine."""
from . import (attention, common, dimenet, fm, gnn, nequip,  # noqa: F401
               so3, transformer)
