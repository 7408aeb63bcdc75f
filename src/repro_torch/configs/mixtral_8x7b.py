"""mixtral-8x7b [arXiv:2401.04088; hf]: 32L d4096 32H GQA(kv=8) ff14336
vocab 32000, MoE 8 experts top-2, sliding-window attention (W=4096)."""
from .base import LM_SHAPES, ShapeCell, TransformerConfig

CONFIG = TransformerConfig(
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=32000, moe=True, n_experts=8, top_k=2,
    sliding_window=4096)

SMOKE = TransformerConfig(
    name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, moe=True, n_experts=4, top_k=2, sliding_window=16)

# SWA => decode over a 500k context is O(window): long_500k runs.
SHAPES = LM_SHAPES()
