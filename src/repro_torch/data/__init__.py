"""Synthetic paper-alike graphs and the neighbor sampler (port of part
of repro.data)."""
from . import sampler  # noqa: F401
from .graphs import (PAPER_DATASETS, DatasetStats, make_paper_dataset,
                     normalized_adjacency, random_edge_list, sbm_graph)

__all__ = ["PAPER_DATASETS", "DatasetStats", "make_paper_dataset",
           "normalized_adjacency", "random_edge_list", "sbm_graph",
           "sampler"]
