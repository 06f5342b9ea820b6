"""Configuration types of the port's `Accelerator` (the part of
`accelerate_tpu/utils/dataclasses.py` its arguments need)."""

from __future__ import annotations

import enum
from dataclasses import asdict, dataclass

import torch


class PrecisionType(str, enum.Enum):
    """The JAX package's precision modes. The port runs ``no`` and ``bf16``;
    ``fp16`` (dynamic loss scaling) and ``fp8`` are still to port."""

    NO = "no"
    FP8 = "fp8"
    FP16 = "fp16"
    BF16 = "bf16"

    @classmethod
    def list(cls):
        return [m.value for m in cls]


#: Compute dtype of each mode the port runs.
COMPUTE_DTYPES = {"no": torch.float32, "bf16": torch.bfloat16}


@dataclass
class GradientAccumulationPlugin:
    """Gradient accumulation settings: the two of the JAX package's fields
    that one process reads."""

    num_steps: int = 1
    sync_with_dataloader: bool = True

    def to_kwargs(self) -> dict:
        return asdict(self)
