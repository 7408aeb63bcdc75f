"""meshgraphnet [arXiv:2010.03409]: 15 MP steps, d128, sum agg, 2-layer MLPs."""
from .base import GNN_SHAPES, GNNConfig

CONFIG = GNNConfig(name="meshgraphnet", kind="meshgraphnet", n_layers=15,
                   d_hidden=128, aggregator="sum", mlp_layers=2, n_classes=3)
SMOKE = GNNConfig(name="meshgraphnet-smoke", kind="meshgraphnet", n_layers=2,
                  d_hidden=16, aggregator="sum", mlp_layers=2, n_classes=3)
SHAPES = GNN_SHAPES()
