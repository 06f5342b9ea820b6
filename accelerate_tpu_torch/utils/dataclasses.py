"""Configuration types of the port's `Accelerator` (the part of
`accelerate_tpu/utils/dataclasses.py` its arguments need)."""

from __future__ import annotations

import enum
from dataclasses import asdict, dataclass
from typing import Optional

import torch


class PrecisionType(str, enum.Enum):
    """The JAX package's precision modes. The port runs ``no``, ``bf16`` and
    ``fp16`` (with dynamic loss scaling); ``fp8`` is still to port."""

    NO = "no"
    FP8 = "fp8"
    FP16 = "fp16"
    BF16 = "bf16"

    @classmethod
    def list(cls):
        return [m.value for m in cls]


#: Compute dtype of each mode the port runs.
COMPUTE_DTYPES = {"no": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


@dataclass
class GradientAccumulationPlugin:
    """Gradient accumulation settings: the two of the JAX package's fields
    that one process reads."""

    num_steps: int = 1
    sync_with_dataloader: bool = True

    def to_kwargs(self) -> dict:
        return asdict(self)


@dataclass
class GradScalerKwargs:
    """Dynamic loss scaling for ``mixed_precision="fp16"``, with the JAX
    package's defaults; passed to `Accelerator(kwargs_handlers=[...])`."""

    init_scale: float = 65536.0
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


@dataclass
class ProjectConfiguration:
    """Where `Accelerator.save_state` writes: with
    `automatic_checkpoint_naming`, ``{project_dir}/checkpoints/checkpoint_{iteration}``
    through `checkpointing.CheckpointManager`, keeping the last `total_limit`.
    Trackers write under `logging_dir`, `project_dir` unless set."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0

    def set_directories(self, project_dir=None):
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        self.set_directories(self.project_dir)


@dataclass
class CompilationConfig:
    """The JAX package's compilation options, of which one has a meaning
    here: `remat_policy` (None or one of `ops.remat.POLICY_NAMES`), the
    activation checkpointing of every in-tree layer. Its XLA-only fields
    (`donate_params`, `scan_layers`, `cache_dir`, `xla_flags`) have no
    counterpart in eager PyTorch and are left out."""

    remat_policy: Optional[str] = None
