"""gatedgcn [arXiv:2003.00982 benchmarking-gnns]: 16L d70, gated edges."""
from .base import GNN_SHAPES, GNNConfig

CONFIG = GNNConfig(name="gatedgcn", kind="gatedgcn", n_layers=16,
                   d_hidden=70, aggregator="gated", n_classes=40)
SMOKE = GNNConfig(name="gatedgcn-smoke", kind="gatedgcn", n_layers=2,
                  d_hidden=16, aggregator="gated", n_classes=4)
SHAPES = GNN_SHAPES()
