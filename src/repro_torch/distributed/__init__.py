"""Distributed training (port of ``repro.distributed``): so far the
fault-tolerant runner."""
from . import fault_tolerance  # noqa: F401
