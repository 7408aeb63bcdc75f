"""fm [Rendle ICDM'10]: factorization machine, 39 sparse fields, k=10,
pairwise via the O(nk) sum-square trick. Criteo-like long-tail vocabs."""
from .base import RECSYS_SHAPES, RecsysConfig

# 39 fields with a Criteo-style long tail: a few huge ID spaces plus many
# small categorical fields (~33.8M total embedding rows).
_VOCABS = (10_000_000, 8_000_000, 5_000_000, 3_000_000, 2_000_000,
           1_500_000, 1_000_000, 800_000, 500_000, 300_000, 200_000,
           100_000, 50_000, 20_000) + (10_000,) * 10 + (1_000,) * 10 \
          + (100,) * 5

CONFIG = RecsysConfig(name="fm", n_sparse=39, embed_dim=10,
                      vocab_sizes=_VOCABS)
assert len(_VOCABS) == 39

SMOKE = RecsysConfig(name="fm-smoke", n_sparse=6, embed_dim=4,
                     vocab_sizes=(100, 50, 40, 30, 20, 10))
SHAPES = RECSYS_SHAPES()
