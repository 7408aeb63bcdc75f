"""Model zoo (port of ``repro.models``): so far the shared blocks and
the message-passing GNNs."""
from . import common, gnn  # noqa: F401
