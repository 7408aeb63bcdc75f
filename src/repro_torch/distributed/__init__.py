"""Distributed training (port of ``repro.distributed``): the
fault-tolerant runner, error-feedback gradient compression, the sharding
rules and their placement, and the halo gather/scatter of 1-D sharded
graphs, on ``torch.distributed``."""
from . import collectives, fault_tolerance, halo, sharding  # noqa: F401
