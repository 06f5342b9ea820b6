"""Seeding (the port of `accelerate_tpu/utils/random.py`'s `set_seed`)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int, device_specific: bool = False) -> int:
    """Seed Python's, numpy's and torch's global generators (every CUDA
    device's too) for user code that draws from them, and return the seed,
    as JAX's `set_seed` does. With `device_specific` the process index is
    added first, so each process draws other noise. The port itself draws only from explicit
    `torch.Generator`s (`device.make_generator`); `Accelerator.save_state`
    saves these global streams and `load_state` restores them."""
    if device_specific:
        from ..state import PartialState

        seed += PartialState().process_index
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed


def rng_states() -> dict:
    """The global streams `set_seed` seeds, as tensors and plain values that
    `torch.load(weights_only=True)` reads back: Python's, numpy's (its key
    array as a list), torch's CPU generator and every CUDA device's."""
    kind, keys, pos, has_gauss, cached = np.random.get_state()
    states = {"python": random.getstate(), "numpy": (kind, keys.tolist(), pos, has_gauss, cached),
              "torch": torch.get_rng_state()}
    if torch.cuda.is_available():
        states["cuda"] = torch.cuda.get_rng_state_all()
    return states


def set_rng_states(states: dict):
    """Restore what `rng_states` returned."""
    random.setstate(states["python"])
    kind, keys, pos, has_gauss, cached = states["numpy"]
    np.random.set_state((kind, np.asarray(keys, dtype=np.uint32), pos, has_gauss, cached))
    torch.set_rng_state(states["torch"])
    if "cuda" in states and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(states["cuda"])
