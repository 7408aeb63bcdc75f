"""dimenet [arXiv:2003.03123]: 6 interaction blocks, d128, bilinear 8,
spherical 7, radial 6 — triplet-gather (angular) kernel regime."""
from .base import GNN_SHAPES, GNNConfig

CONFIG = GNNConfig(name="dimenet", kind="dimenet", n_layers=6, d_hidden=128,
                   n_bilinear=8, n_spherical=7, n_radial=6, cutoff=5.0)
SMOKE = GNNConfig(name="dimenet-smoke", kind="dimenet", n_layers=2,
                  d_hidden=16, n_bilinear=2, n_spherical=3, n_radial=4,
                  cutoff=5.0)
SHAPES = GNN_SHAPES()
