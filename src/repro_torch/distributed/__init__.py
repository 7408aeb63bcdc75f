"""Distributed training (port of ``repro.distributed``): the
fault-tolerant runner, error-feedback gradient compression, the sharding
rules and their placement, the halo gather/scatter of 1-D sharded
graphs, and the tensor-, sequence- and fully-sharded data-parallel
collectives of the LM (``tp``, the port's own), on
``torch.distributed``."""
from . import collectives, fault_tolerance, halo, sharding, tp  # noqa: F401
