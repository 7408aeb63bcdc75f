"""Model zoo (port of ``repro.models``): the shared blocks, the
message-passing GNNs, the transformer family with its chunked attention,
and the factorization machine."""
from . import attention, common, fm, gnn, transformer  # noqa: F401
