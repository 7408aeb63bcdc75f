"""Synthetic data (port of ``repro.data``): the paper-alike graphs, the
random molecules, the neighbor sampler, the LM token stream and the
click stream."""
from . import sampler  # noqa: F401
from .graphs import (PAPER_DATASETS, DatasetStats, make_paper_dataset,
                     normalized_adjacency, random_edge_list,
                     random_molecules, sbm_graph)
from .recsys import ClickStream
from .tokens import TokenStream

__all__ = ["PAPER_DATASETS", "ClickStream", "DatasetStats", "TokenStream",
           "make_paper_dataset", "normalized_adjacency", "random_edge_list",
           "random_molecules", "sbm_graph", "sampler"]
