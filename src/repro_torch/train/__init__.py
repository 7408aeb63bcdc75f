"""Training: optimizers and train/serve step factories
(port of ``repro.train``)."""
from . import optimizer, steps  # noqa: F401
