"""qwen3-0.6b [hf:Qwen/Qwen3-family]: 28L d1024 16H GQA(kv=8) ff3072
vocab 151936, qk-norm."""
from .base import LM_SHAPES, TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab=151936, qk_norm=True)

SMOKE = TransformerConfig(
    name="qwen3-0.6b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, qk_norm=True)

SHAPES = LM_SHAPES()
for _c in SHAPES:
    if _c.name == "long_500k":
        object.__setattr__(_c, "skip",
                           "pure full attention: O(L^2) at 524k by design")
