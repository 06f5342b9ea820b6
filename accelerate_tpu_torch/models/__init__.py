"""In-tree model families of the port (the Llama slice of
`accelerate_tpu/models/__init__.py`)."""

from __future__ import annotations

import torch

from ..device import DeviceLike
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    create_llama_model,
    llama3_8b,
    llama_1b,
    llama_state_dict_from_flax,
    llama_tiny,
)

#: name -> config factory, the subset of the JAX package's MODEL_REGISTRY the
#: port serves.
MODEL_REGISTRY = {
    "llama-3-8b": llama3_8b,
    "llama-1b": llama_1b,
    "llama-tiny": llama_tiny,
}


def create_named_model(
    name: str, seed: int = 0, dtype: torch.dtype = torch.float32, device: DeviceLike = None
) -> LlamaForCausalLM:
    """A registered model at its published widths, random weights from `seed`."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; expected one of {sorted(MODEL_REGISTRY)}")
    return create_llama_model(MODEL_REGISTRY[name](), seed=seed, dtype=dtype, device=device)
