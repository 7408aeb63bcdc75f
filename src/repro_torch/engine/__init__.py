"""Serving-oriented execution layer over the tri-partition (port of
repro.engine): shape classes, the executor cache, the Engine and the
shape-class lifecycle."""
from .executor import CacheStats, ExecutorCache
from .lifecycle import LifecycleConfig, LifecycleManager, RetirementPlan
from .serving import Engine, GraphHandle
from .shape_class import (DEFAULT_K_LADDER, ClassNeed, ClassRegistry,
                          ShapeClass, ShapePolicy, class_fits,
                          class_requirements, grow_class, pad_to_class,
                          round_up_ladder, round_up_pow2, shape_class_of,
                          unpad_from_class)

__all__ = [
    "CacheStats", "ExecutorCache", "Engine", "GraphHandle",
    "LifecycleConfig", "LifecycleManager", "RetirementPlan",
    "DEFAULT_K_LADDER", "ClassNeed", "ClassRegistry", "ShapeClass",
    "ShapePolicy", "class_fits", "class_requirements", "grow_class",
    "pad_to_class", "round_up_ladder", "round_up_pow2", "shape_class_of",
    "unpad_from_class",
]
