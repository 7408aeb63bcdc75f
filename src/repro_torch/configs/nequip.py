"""nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2, 8 RBF,
cutoff 5 — E(3)-equivariant tensor-product kernel regime."""
from .base import GNN_SHAPES, GNNConfig

CONFIG = GNNConfig(name="nequip", kind="nequip", n_layers=5, d_hidden=32,
                   l_max=2, n_rbf=8, cutoff=5.0)
SMOKE = GNNConfig(name="nequip-smoke", kind="nequip", n_layers=2, d_hidden=8,
                  l_max=1, n_rbf=4, cutoff=5.0)
SHAPES = GNN_SHAPES()
