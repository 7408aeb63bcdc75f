"""Synthetic paper-alike graphs (port of part of repro.data)."""
from .graphs import (PAPER_DATASETS, DatasetStats, make_paper_dataset,
                     normalized_adjacency, sbm_graph)

__all__ = ["PAPER_DATASETS", "DatasetStats", "make_paper_dataset",
           "normalized_adjacency", "sbm_graph"]
