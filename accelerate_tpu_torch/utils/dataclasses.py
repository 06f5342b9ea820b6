"""Configuration types of the port's `Accelerator` (the part of
`accelerate_tpu/utils/dataclasses.py` its arguments need)."""

from __future__ import annotations

import enum
from dataclasses import asdict, dataclass
from typing import Optional

import torch


class PrecisionType(str, enum.Enum):
    """The JAX package's precision modes, all of which the port runs: ``no``,
    ``bf16``, ``fp16`` (with dynamic loss scaling) and ``fp8`` (bf16 compute,
    every linear layer's product in fp8 under `FP8RecipeKwargs`)."""

    NO = "no"
    FP8 = "fp8"
    FP16 = "fp16"
    BF16 = "bf16"

    @classmethod
    def list(cls):
        return [m.value for m in cls]


#: Compute dtype of each mode (fp8's linear products aside, bf16 under fp8).
COMPUTE_DTYPES = {"no": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16, "fp8": torch.bfloat16}


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
class FP8RecipeKwargs:
    """The fp8 recipe of ``mixed_precision="fp8"``, with the JAX package's
    fields, defaults and checks; passed to `Accelerator(kwargs_handlers=[...])`.
    `fp8_format` "HYBRID" takes the backward's gradients in e5m2, "E4M3"
    everything in e4m3; `scaling` "dynamic" scales each tensor by its own
    amax, "delayed" by a rolling window of `amax_history_len` amaxes
    (`ops/fp8.py`). `margin`, `interval` and `override_linear_precision` are
    accepted and, as in the JAX package, read by nothing."""

    margin: int = 0
    interval: int = 1
    fp8_format: str = "HYBRID"  # E4M3 | HYBRID
    scaling: str = "dynamic"  # dynamic | delayed
    amax_history_len: int = 1024
    amax_compute_algo: str = "most_recent"
    override_linear_precision: tuple = (False, False, False)

    def __post_init__(self):
        self.fp8_format = self.fp8_format.upper()
        if self.fp8_format not in ("E4M3", "HYBRID"):
            raise ValueError("fp8_format must be E4M3 or HYBRID")
        self.scaling = self.scaling.lower()
        if self.scaling not in ("dynamic", "delayed"):
            raise ValueError("scaling must be dynamic or delayed")
        if self.amax_compute_algo not in ("max", "most_recent"):
            raise ValueError("amax_compute_algo must be max or most_recent")


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
