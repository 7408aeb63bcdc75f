"""Launch-time layout (port of ``repro.launch``): device meshes, elastic
resharding, the local multi-process launcher the sharded layer is
tested with, and ``specs``, the builder of every (architecture x cell)
program."""
import importlib

from . import elastic, local, mesh  # noqa: F401

__all__ = ["elastic", "local", "mesh", "specs"]


def __getattr__(name):
    # specs imports the models and the sharding rules, which import this
    # package: it loads on first use
    if name == "specs":
        return importlib.import_module(f"{__name__}.specs")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
