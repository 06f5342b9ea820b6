"""Seeding (the port of `accelerate_tpu/utils/random.py`'s `set_seed`)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> int:
    """Seed Python's, numpy's and torch's global generators (every CUDA
    device's too) for user code that draws from them, and return the seed,
    as JAX's `set_seed` does. The port itself draws only from explicit
    `torch.Generator`s (`device.make_generator`)."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed
