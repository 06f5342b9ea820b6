"""Utilities of the port's training slice."""

from .dataclasses import (
    CompilationConfig,
    DistributedType,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    ParallelismConfig,
    PrecisionType,
    ProjectConfiguration,
)
from .operations import send_to_device
from .random import set_seed

__all__ = [
    "CompilationConfig",
    "DistributedType",
    "FP8RecipeKwargs",
    "FullyShardedDataParallelPlugin",
    "GradScalerKwargs",
    "GradientAccumulationPlugin",
    "ParallelismConfig",
    "PrecisionType",
    "ProjectConfiguration",
    "send_to_device",
    "set_seed",
]
