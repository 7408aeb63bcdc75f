"""smollm-360m [hf:HuggingFaceTB/SmolLM-family]: llama-arch small,
32L d960 15H GQA(kv=5) ff2560 vocab 49152."""
from .base import LM_SHAPES, TransformerConfig

CONFIG = TransformerConfig(
    name="smollm-360m", n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152)

SMOKE = TransformerConfig(
    name="smollm-smoke", n_layers=2, d_model=60, n_heads=3, n_kv_heads=1,
    d_ff=128, vocab=256)

SHAPES = LM_SHAPES()
for _c in SHAPES:
    if _c.name == "long_500k":
        object.__setattr__(_c, "skip",
                           "pure full attention: O(L^2) at 524k by design")
