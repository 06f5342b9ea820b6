"""In-tree model families of the port (the Llama, BERT, GPT-NeoX, GPT-J, OPT,
T5, Mixtral and ResNet slices of `accelerate_tpu/models/__init__.py`).

Each family has its config, its `create_*` factory (random weights from a
seed, made on the device) and its carry function, ``*_state_dict_from_flax``,
which takes a JAX params tree to the port's `state_dict`. ResNet, an image
model, is exported but not registered, as in the JAX package."""

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
from .gpt_neox import (
    GPTNeoXConfig,
    GPTNeoXForCausalLM,
    create_gpt_neox_model,
    gpt_neox_20b,
    gpt_neox_state_dict_from_flax,
    gpt_neox_tiny,
)
from .gptj import GPTJConfig, GPTJForCausalLM, create_gptj_model, gptj_6b, gptj_state_dict_from_flax, gptj_tiny
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    create_llama_model,
    llama3_8b,
    llama_1b,
    llama_state_dict_from_flax,
    llama_tiny,
)
from .mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
    create_mixtral_model,
    make_moe_causal_lm_loss,
    mixtral_8x7b,
    mixtral_state_dict_from_flax,
    mixtral_tiny,
)
from .opt import OPTConfig, OPTForCausalLM, create_opt_model, opt_30b, opt_state_dict_from_flax, opt_tiny
from .resnet import (
    ResNet,
    ResNetConfig,
    create_resnet_model,
    image_classification_loss,
    resnet18_ish,
    resnet50,
    resnet_state_dict_from_flax,
    resnet_tiny,
)
from .t5 import (
    T5Config,
    T5ForConditionalGeneration,
    create_t5_model,
    seq2seq_lm_loss,
    t0pp_11b,
    t5_small_v1_0,
    t5_state_dict_from_flax,
    t5_tiny,
    t5_tiny_v1_0,
)

#: name -> config factory, the subset of the JAX package's MODEL_REGISTRY the
#: port runs.
MODEL_REGISTRY = {
    "llama-3-8b": llama3_8b,
    "llama-1b": llama_1b,
    "llama-tiny": llama_tiny,
    "bert-base": bert_base,
    "bert-tiny": bert_tiny,
    "gptj-6b": gptj_6b,
    "gptj-tiny": gptj_tiny,
    "gpt-neox-20b": gpt_neox_20b,
    "gpt-neox-tiny": gpt_neox_tiny,
    "opt-30b": opt_30b,
    "opt-tiny": opt_tiny,
    "t0pp-11b": t0pp_11b,
    "t5-tiny": t5_tiny,
    "t5-small": t5_small_v1_0,
    "t5-tiny-v1-0": t5_tiny_v1_0,
    "mixtral-8x7b": mixtral_8x7b,
    "mixtral-tiny": mixtral_tiny,
}

#: config type -> the family's model factory (JAX's CREATE_BY_FAMILY).
CREATE_BY_FAMILY = {
    LlamaConfig: create_llama_model,
    BertConfig: create_bert_model,
    GPTJConfig: create_gptj_model,
    GPTNeoXConfig: create_gpt_neox_model,
    OPTConfig: create_opt_model,
    T5Config: create_t5_model,
    MixtralConfig: create_mixtral_model,
}


def create_named_model(
    name: str, seed: int = 0, dtype: torch.dtype = torch.float32, device: DeviceLike = None
) -> nn.Module:
    """A registered model at its published widths, random weights from `seed`."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; expected one of {sorted(MODEL_REGISTRY)}")
    config = MODEL_REGISTRY[name]()
    return CREATE_BY_FAMILY[type(config)](config, seed=seed, dtype=dtype, device=device)
