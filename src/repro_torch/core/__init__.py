"""Reordering, tri-partitioning and the hybrid SpMM (port of repro.core)."""
from .formats import (CSRMatrix, CooResidual, DenseTiles, EllTileBucket,
                      PartitionMeta, RaggedEll, ReductionPlan, SegmentPlan,
                      TriPartition, csr_from_dense, csr_from_scipy,
                      csr_to_scipy, ell_buckets, empty_ragged_ell,
                      pad_b_to_tiles, partition_to, partition_to_dense,
                      reduction_plan, scatter_ell_partials)
from .grouping import Group, MovingAverage, group_rows, grouping_density
from .hybrid_spmm import (gcn_forward, gcn_layer, hybrid_spmm,
                          hybrid_spmm_ref)
from .partition import PartitionConfig, analyze_and_partition, find_nnz
from .reorder import (apply_permutation, bandwidth, compute_permutation,
                      reorder, tile_density_histogram)

__all__ = [
    "CSRMatrix", "CooResidual", "DenseTiles", "EllTileBucket",
    "PartitionMeta", "RaggedEll", "ReductionPlan", "SegmentPlan",
    "TriPartition", "csr_from_dense", "csr_from_scipy", "csr_to_scipy",
    "ell_buckets", "empty_ragged_ell", "pad_b_to_tiles", "partition_to",
    "partition_to_dense", "reduction_plan", "scatter_ell_partials", "Group",
    "MovingAverage", "group_rows", "grouping_density", "gcn_forward",
    "gcn_layer", "hybrid_spmm", "hybrid_spmm_ref", "PartitionConfig",
    "analyze_and_partition", "find_nnz", "apply_permutation", "bandwidth",
    "compute_permutation", "reorder", "tile_density_histogram",
]
