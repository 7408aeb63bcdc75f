"""Launch-time layout (port of ``repro.launch``): device meshes, elastic
resharding, and the local multi-process launcher the sharded layer is
tested with."""
from . import elastic, local, mesh  # noqa: F401
