"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B-style]: 94L d4096 64H
GQA(kv=4) per-expert ff1536, vocab 151936, MoE 128 experts top-8, qk-norm."""
from .base import LM_SHAPES, TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
    n_kv_heads=4, d_ff=1536, vocab=151936, moe=True, n_experts=128,
    top_k=8, qk_norm=True)

SMOKE = TransformerConfig(
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, moe=True, n_experts=8, top_k=2, qk_norm=True)

SHAPES = LM_SHAPES()
for _c in SHAPES:
    if _c.name == "long_500k":
        object.__setattr__(_c, "skip",
                           "pure full attention: O(L^2) at 524k by design")
