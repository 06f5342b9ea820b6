"""In-tree model families of the port (the Llama and BERT slices of
`accelerate_tpu/models/__init__.py`)."""

from __future__ import annotations

import torch
from torch import nn

from ..device import DeviceLike
from .bert import (
    BertConfig,
    BertForSequenceClassification,
    bert_base,
    bert_state_dict_from_flax,
    bert_tiny,
    create_bert_model,
)
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
#: port runs.
MODEL_REGISTRY = {
    "llama-3-8b": llama3_8b,
    "llama-1b": llama_1b,
    "llama-tiny": llama_tiny,
    "bert-base": bert_base,
    "bert-tiny": bert_tiny,
}

#: config type -> the family's model factory (JAX's CREATE_BY_FAMILY).
CREATE_BY_FAMILY = {
    LlamaConfig: create_llama_model,
    BertConfig: create_bert_model,
}


def create_named_model(
    name: str, seed: int = 0, dtype: torch.dtype = torch.float32, device: DeviceLike = None
) -> nn.Module:
    """A registered model at its published widths, random weights from `seed`."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; expected one of {sorted(MODEL_REGISTRY)}")
    config = MODEL_REGISTRY[name]()
    return CREATE_BY_FAMILY[type(config)](config, seed=seed, dtype=dtype, device=device)
