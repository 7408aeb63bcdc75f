"""granite-8b [arXiv:2405.04324; hf]: llama-arch dense code model,
36L d4096 32H GQA(kv=8) ff14336 vocab 49152."""
from .base import LM_SHAPES, TransformerConfig

# parallelism="fsdp": §Perf hillclimb result — an 8B dense model on 256
# chips is fastest with pure ZeRO-3 (batch 256 = one sequence per device);
# Megatron TP+SP costs 2.8x more collective time at this scale.
CONFIG = TransformerConfig(
    name="granite-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, parallelism="fsdp")

SMOKE = TransformerConfig(
    name="granite-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256)

SHAPES = LM_SHAPES()
for _c in SHAPES:
    if _c.name == "long_500k":
        object.__setattr__(_c, "skip",
                           "pure full attention: O(L^2) at 524k by design")
