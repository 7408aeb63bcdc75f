"""Architecture registry (port of ``repro.configs``, copied whole: pure
dataclasses): ``get_arch(id)`` -> (CONFIG, SMOKE, SHAPES)."""
from __future__ import annotations

import dataclasses
import importlib

from .base import (GNNConfig, RecsysConfig, ShapeCell,  # noqa: F401
                   TransformerConfig)

# arch id -> module name
ARCHS = {
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-8b": "granite_8b",
    "qwen3-0.6b": "qwen3_0_6b",
    "smollm-360m": "smollm_360m",
    "dimenet": "dimenet",
    "meshgraphnet": "meshgraphnet",
    "gatedgcn": "gatedgcn",
    "nequip": "nequip",
    "fm": "fm",
    "gcn-paper": "gcn_paper",       # the paper's own model (not in the 40)
}

ASSIGNED = [a for a in ARCHS if a != "gcn-paper"]


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    config: object
    smoke: object
    shapes: list

    @property
    def family(self) -> str:
        return self.config.family


def get_arch(name: str) -> Arch:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {list(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return Arch(name, mod.CONFIG, mod.SMOKE, mod.SHAPES)


def all_cells(include_paper: bool = False):
    """Every (arch, shape-cell) pair in the assigned grid (40 cells)."""
    names = list(ARCHS) if include_paper else ASSIGNED
    out = []
    for name in names:
        arch = get_arch(name)
        for cell in arch.shapes:
            out.append((arch, cell))
    return out
