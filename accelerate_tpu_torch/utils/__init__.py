"""Utilities of the port's training slice."""

from .dataclasses import (
    AutocastKwargs,
    CompilationConfig,
    DataLoaderConfiguration,
    DistributedDataParallelKwargs,
    DistributedType,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    KwargsHandler,
    ParallelismConfig,
    PrecisionType,
    ProjectConfiguration,
    RNGType,
)
from .memory import find_executable_batch_size, is_oom_exception, release_memory
from .operations import send_to_device
from .random import set_seed, synchronize_rng_state, synchronize_rng_states

__all__ = [
    "AutocastKwargs",
    "CompilationConfig",
    "DataLoaderConfiguration",
    "DistributedDataParallelKwargs",
    "DistributedType",
    "FP8RecipeKwargs",
    "FullyShardedDataParallelPlugin",
    "GradScalerKwargs",
    "GradientAccumulationPlugin",
    "InitProcessGroupKwargs",
    "KwargsHandler",
    "ParallelismConfig",
    "PrecisionType",
    "ProjectConfiguration",
    "RNGType",
    "find_executable_batch_size",
    "is_oom_exception",
    "release_memory",
    "send_to_device",
    "set_seed",
    "synchronize_rng_state",
    "synchronize_rng_states",
]
