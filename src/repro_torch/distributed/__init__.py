"""Distributed training (port of ``repro.distributed``): so far the
fault-tolerant runner and error-feedback gradient compression."""
from . import collectives, fault_tolerance  # noqa: F401
