"""Config dataclasses + the shape-cell grid for every assigned architecture."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 -> d_model // n_heads
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # SWA width (mixtral: 4096)
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    parallelism: str = "tp_fsdp"   # "tp_fsdp" (Megatron TP+SP+ZeRO) or
    #                                "fsdp" (pure DP over all axes + ZeRO-3)
    family: str = "lm"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def n_params_dense(self) -> int:
        d, f, l, v = self.d_model, self.d_ff, self.n_layers, self.vocab
        attn = d * (self.n_heads * self.d_head) * 2 \
            + d * (self.n_kv_heads * self.d_head) * 2
        ffn = 3 * d * f * (self.n_experts if self.moe else 1)
        return l * (attn + ffn) + 2 * v * d

    @property
    def n_params_active(self) -> int:
        if not self.moe:
            return self.n_params_dense
        d, f, l = self.d_model, self.d_ff, self.n_layers
        attn = d * (self.n_heads * self.d_head) * 2 \
            + d * (self.n_kv_heads * self.d_head) * 2
        ffn = 3 * d * f * self.top_k
        return l * (attn + ffn) + 2 * self.vocab * d


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                 # gatedgcn | meshgraphnet | dimenet | nequip | gcn
    n_layers: int
    d_hidden: int
    d_in: int = 0             # node feature dim (shape-dependent if 0)
    d_edge: int = 0
    n_classes: int = 0
    aggregator: str = "sum"
    mlp_layers: int = 2
    # dimenet
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    # nequip
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    family: str = "gnn"


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_sparse: int = 39
    embed_dim: int = 10
    interaction: str = "fm-2way"
    # per-field vocabulary sizes (Criteo-like long tail, ~34M total rows)
    vocab_sizes: tuple = ()
    n_dense: int = 0
    family: str = "recsys"


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) grid cell."""

    name: str                 # e.g. "train_4k"
    kind: str                 # train | prefill | decode | graph_full |
    #                           graph_minibatch | graph_batched | rec_train |
    #                           rec_serve | rec_retrieval
    seq_len: int = 0
    global_batch: int = 0
    # gnn
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple = ()
    # recsys
    n_candidates: int = 0
    skip: str = ""            # non-empty -> cell is skipped, with reason


LM_SHAPES = lambda: [
    ShapeCell("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeCell("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeCell("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeCell("long_500k", "decode", seq_len=524288, global_batch=1),
]

GNN_SHAPES = lambda: [
    ShapeCell("full_graph_sm", "graph_full", n_nodes=2708, n_edges=10556,
              d_feat=1433),
    ShapeCell("minibatch_lg", "graph_minibatch", n_nodes=232965,
              n_edges=114_615_892, batch_nodes=1024, fanout=(15, 10),
              d_feat=602),
    ShapeCell("ogb_products", "graph_full", n_nodes=2_449_029,
              n_edges=61_859_140, d_feat=100),
    ShapeCell("molecule", "graph_batched", n_nodes=30, n_edges=64,
              global_batch=128, d_feat=0),
]

RECSYS_SHAPES = lambda: [
    ShapeCell("train_batch", "rec_train", global_batch=65536),
    ShapeCell("serve_p99", "rec_serve", global_batch=512),
    ShapeCell("serve_bulk", "rec_serve", global_batch=262144),
    ShapeCell("retrieval_cand", "rec_retrieval", global_batch=1,
              n_candidates=1_000_000),
]
