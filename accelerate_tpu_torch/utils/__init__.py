"""Utilities of the port's training slice."""

from .dataclasses import (
    CompilationConfig,
    FP8RecipeKwargs,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    PrecisionType,
    ProjectConfiguration,
)
from .operations import send_to_device
from .random import set_seed

__all__ = [
    "CompilationConfig",
    "FP8RecipeKwargs",
    "GradScalerKwargs",
    "GradientAccumulationPlugin",
    "PrecisionType",
    "ProjectConfiguration",
    "send_to_device",
    "set_seed",
]
