"""Roofline terms of a step from its counted ops (port of
``repro.analysis.roofline``).

The reference holds a TPU's peaks; these are one NVIDIA H100 SXM's,
from NVIDIA's data sheet (dense rates at the card's full 700 W power
limit). They are data-sheet figures, not measurements:

  dense bf16 (tensor cores)          989 TFLOP/s
  float32 FFMA (CUDA cores)           67 TFLOP/s
  HBM3                              3.35 TB/s
  NVLink 4, per direction per GPU    450 GB/s   (within a node of 8)
  InfiniBand NDR, per GPU             50 GB/s   (across nodes)

Terms (seconds, per step, per rank), as the reference's:
  compute    = FLOPs / peak of the products' dtype
  memory     = bytes / HBM
  collective = each collective's traffic over the link its group crosses

``PEAK_FLOPS`` and ``HBM_BW`` are what ``Engine.latency_prior`` reads:
the GCN's kernels and its X·W run in float32 outside the tensor cores
(TF32 is off), so its compute peak is the FFMA rate.

The counts come from ``analysis.op_trace.OpCounter`` (per rank, over
eager aten ops: no fusion), by ``launch/dryrun.py`` on fake tensors or
around a real step.
"""
from __future__ import annotations

import dataclasses
import json

from .op_trace import collective_summary, parse_collectives

PEAK_FLOPS = 67e12           # float32 FLOP/s, CUDA cores (FFMA)
HBM_BW = 3.35e12             # device memory bytes/s (HBM3)
BF16_FLOPS = 989e12          # dense bf16 FLOP/s, tensor cores
NVLINK_BW = 450e9            # bytes/s per direction per GPU, NVLink 4
IB_BW = 50e9                 # bytes/s per GPU, InfiniBand NDR (400 Gb/s)
NODE_GPUS = 8                # GPUs a node joins by NVLink

# the products' dtypes that run on the tensor cores
_TENSOR_CORE = ("bfloat16", "float16")


@dataclasses.dataclass
class Roofline:
    arch: str
    cell: str
    mesh: str
    chips: int
    hlo_flops: float                  # per chip
    hlo_bytes: float                  # per chip
    collective_bytes: float           # per chip
    model_flops: float
    per_device_memory: float          # bytes (peak live)
    collectives: dict
    peak_flops: float = BF16_FLOPS
    hbm_bw: float = HBM_BW
    nvlink_bw: float = NVLINK_BW
    ib_bw: float = IB_BW
    peak_reason: str = ""

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        """Each collective's traffic over its link: ``collectives
        ["by_link"]`` (NVLink within a node, InfiniBand across), or all
        of it over NVLink where the record has no split."""
        links = self.collectives.get("by_link")
        if links is None:
            return self.collective_bytes / self.nvlink_bw
        return (links.get("nvlink", 0.0) / self.nvlink_bw
                + links.get("ib", 0.0) / self.ib_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips * HLO_FLOPs) — remat/redundancy waste."""
        return self.model_flops / max(self.chips * self.hlo_flops, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Model-flops utilization at the roofline bound (the score)."""
        t_model = self.model_flops / (self.chips * self.peak_flops)
        return t_model / max(self.t_bound, 1e-30)

    def peaks(self) -> dict:
        """The rates the terms were taken against, and why this compute
        peak (data-sheet figures of one H100 SXM at 700 W)."""
        return {"flops_per_s": self.peak_flops, "hbm_bytes_per_s":
                self.hbm_bw, "nvlink_bytes_per_s": self.nvlink_bw,
                "ib_bytes_per_s": self.ib_bw, "compute": self.peak_reason,
                "source": "NVIDIA H100 SXM data sheet, 700 W"}

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "cell": self.cell, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "per_device_memory": self.per_device_memory,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "collectives": self.collectives,
        }


def merge_cost_analysis(ca) -> dict:
    """Merge per-phase count dicts into one flat dict (one dict passes
    through): numeric entries are summed, other entries keep the first
    value seen."""
    if ca is None:
        return {}
    if isinstance(ca, dict):
        return dict(ca)
    merged: dict = {}
    for entry in ca:
        for k, v in (entry or {}).items():
            try:
                merged[k] = merged.get(k, 0.0) + float(v)
            except (TypeError, ValueError):
                merged.setdefault(k, v)
    return merged


def link_of(ranks) -> str:
    """"nvlink" where every rank of a group lies in one node (ranks are
    row-major over the mesh, ``launch/mesh.py``, a node holding
    ``NODE_GPUS`` consecutive ranks), else "ib"."""
    return "nvlink" if len({r // NODE_GPUS for r in ranks}) <= 1 else "ib"


def compute_peak(flops_by_dtype: dict) -> tuple:
    """(peak FLOP/s, why) of a step whose matrix products have
    ``flops_by_dtype``: the bf16 tensor-core rate where any product has
    16-bit operands, else the float32 FFMA rate (TF32 is off). FLOPs
    counted at the faster rate only lower the bound."""
    total = sum(flops_by_dtype.values())
    fast = sum(v for k, v in flops_by_dtype.items() if k in _TENSOR_CORE)
    if fast:
        return BF16_FLOPS, (f"dense bf16: {fast:.6g} of {total:.6g} "
                            "product FLOPs have 16-bit operands")
    if not total:
        return PEAK_FLOPS, "float32 FFMA: no matrix products"
    return PEAK_FLOPS, (f"float32 FFMA: the {total:.6g} product FLOPs have "
                        f"{'/'.join(sorted(flops_by_dtype))} operands")


def analyze_trace(arch, cell, mesh_name, chips, counts,
                  model_flops) -> Roofline:
    """The roofline of one rank's counted step (``OpCounter.counts()``)."""
    ops = parse_collectives(counts["collectives"])
    summ = collective_summary(counts["collectives"])
    by_link = {"nvlink": 0.0, "ib": 0.0}
    for op in ops:
        by_link[link_of(op.ranks)] += op.traffic_bytes
    summ["by_link"] = by_link
    peak, why = compute_peak(counts["flops_by_dtype"])
    return Roofline(arch, cell, mesh_name, chips, float(counts["flops"]),
                    float(counts["bytes"]),
                    float(summ["total_traffic_bytes"]), model_flops,
                    float(counts["peak_bytes"]), summ, peak_flops=peak,
                    peak_reason=why)


def save_json(records, path):
    with open(path, "w") as f:
        json.dump([r if isinstance(r, dict) else r.to_dict()
                   for r in records], f, indent=1)


def fmt_seconds(t: float) -> str:
    if t >= 1.0:
        return f"{t:.2f}s"
    if t >= 1e-3:
        return f"{t * 1e3:.2f}ms"
    return f"{t * 1e6:.1f}us"
