"""The paper's own model: 2-layer vanilla GCN, hidden 128 (H-GCN §V-A),
evaluated on Cora/Citeseer/Pubmed/Flickr/Reddit/Yelp/Amazon."""
from .base import GNNConfig, ShapeCell

CONFIG = GNNConfig(name="gcn-paper", kind="gcn", n_layers=2, d_hidden=128,
                   n_classes=16)
SMOKE = GNNConfig(name="gcn-smoke", kind="gcn", n_layers=2, d_hidden=16,
                  n_classes=4)

# the paper's datasets (Table I) as shape cells
SHAPES = [
    ShapeCell("cora", "graph_full", n_nodes=2708, n_edges=10556, d_feat=1433),
    ShapeCell("citeseer", "graph_full", n_nodes=3327, n_edges=9104,
              d_feat=3703),
    ShapeCell("pubmed", "graph_full", n_nodes=19717, n_edges=88648,
              d_feat=500),
    ShapeCell("flickr", "graph_full", n_nodes=89250, n_edges=899756,
              d_feat=500),
    ShapeCell("reddit", "graph_full", n_nodes=232965, n_edges=114_615_892,
              d_feat=602),
    ShapeCell("yelp", "graph_full", n_nodes=716847, n_edges=13_954_819,
              d_feat=300),
    ShapeCell("amazon", "graph_full", n_nodes=1_569_960, n_edges=264_339_468,
              d_feat=200),
]
