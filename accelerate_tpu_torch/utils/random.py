"""Seeding and the agreement of host generators across processes (the port
of `accelerate_tpu/utils/random.py`: `set_seed`, `synchronize_rng_state(s)`)."""

from __future__ import annotations

import random
from typing import Iterable, Optional

import numpy as np
import torch

from .dataclasses import RNGType


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


def synchronize_rng_state(rng_type: Optional[RNGType] = None, generator=None):
    """Give every process process 0's state of one generator, through
    `broadcast_object_list`; nothing with one process. ``python`` and
    ``numpy`` are the global streams; ``generator`` a loader's sampler (a
    `SeedableRandomSampler`'s `state_dict`, or a `torch.Generator`'s
    `get_state`); ``torch`` torch's default CPU generator. JAX's ``jax``
    entry is a no-op, its keys agreeing across processes by construction;
    torch's default generator holds state in each process, so it is
    broadcast like the others, which gives the same guarantee."""
    from .operations import _num_processes, broadcast_object_list

    if _num_processes() == 1:
        return
    rng_type = RNGType(rng_type)
    if rng_type == RNGType.PYTHON:
        random.setstate(broadcast_object_list([random.getstate()])[0])
    elif rng_type == RNGType.NUMPY:
        np.random.set_state(broadcast_object_list([np.random.get_state()])[0])
    elif rng_type == RNGType.TORCH:
        torch.set_rng_state(broadcast_object_list([torch.get_rng_state()])[0])
    elif rng_type == RNGType.GENERATOR and generator is not None:
        if hasattr(generator, "state_dict"):
            generator.load_state_dict(broadcast_object_list([generator.state_dict()])[0])
        else:
            generator.set_state(broadcast_object_list([generator.get_state()])[0])


def synchronize_rng_states(rng_types: Iterable[str], generator=None):
    """`synchronize_rng_state` of each of `rng_types`, in order."""
    for rng_type in rng_types:
        synchronize_rng_state(RNGType(rng_type), generator=generator)
