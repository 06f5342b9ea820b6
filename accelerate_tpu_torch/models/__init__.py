"""In-tree model families of the port (the Llama, BERT, GPT-NeoX, GPT-J, OPT,
T5, Mixtral and ResNet slices of `accelerate_tpu/models/__init__.py`).

Each family has its config, its `create_*` factory (random weights from a
seed, made on the device) and its carry function, ``*_state_dict_from_flax``,
which takes a JAX params tree to the port's `state_dict`. ResNet, an image
model, is exported but not registered, as in the JAX package. The causal
families and T5 have a `LayeredApply` for big-model inference
(`layered_for_family`, `layered_for_model`). Every family but Mixtral
(which waits for expert sharding) sets ``tensor_parallel``: its forward
splits over a "model" axis by its rules table (`parallel.tensor`)."""

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
    GPTNeoXLayeredApply,
    create_gpt_neox_model,
    gpt_neox_20b,
    gpt_neox_state_dict_from_flax,
    gpt_neox_tiny,
)
from .gptj import (
    GPTJConfig,
    GPTJForCausalLM,
    GPTJLayeredApply,
    create_gptj_model,
    gptj_6b,
    gptj_state_dict_from_flax,
    gptj_tiny,
)
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    LlamaLayeredApply,
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
from .opt import (
    OPTConfig,
    OPTForCausalLM,
    OPTLayeredApply,
    create_opt_model,
    opt_30b,
    opt_state_dict_from_flax,
    opt_tiny,
)
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
    T5LayeredApply,
    create_t5_model,
    seq2seq_lm_loss,
    t0pp_11b,
    t5_small_v1_0,
    t5_state_dict_from_flax,
    t5_tiny,
    t5_tiny_v1_0,
)

#: name -> config factory, the subset of the JAX package's MODEL_REGISTRY the
#: port runs. JAX's entries pair each factory with its interchange family;
#: the port reads the family off the config's type (`FAMILY_BY_CONFIG`,
#: `get_model_family`), so an entry added here needs nothing more.
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

#: config type -> the interchange family (`utils/hf_loading.py`'s keys, and
#: BERT's), JAX's ``MODEL_REGISTRY[name][0]``.
FAMILY_BY_CONFIG = {
    LlamaConfig: "llama",
    BertConfig: "bert",
    GPTJConfig: "gptj",
    GPTNeoXConfig: "gpt_neox",
    OPTConfig: "opt",
    T5Config: "t5",
    MixtralConfig: "mixtral",
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


#: config type -> the family's module class (`big_modeling.init_empty_weights`).
MODULE_BY_CONFIG = {
    LlamaConfig: LlamaForCausalLM,
    BertConfig: BertForSequenceClassification,
    GPTJConfig: GPTJForCausalLM,
    GPTNeoXConfig: GPTNeoXForCausalLM,
    OPTConfig: OPTForCausalLM,
    T5Config: T5ForConditionalGeneration,
    MixtralConfig: MixtralForCausalLM,
}

#: family -> the module class name of the families shipping a
#: prelude/layers/tail decomposition (JAX's `LAYERED_BY_FAMILY`; T5's
#: `T5LayeredApply` is constructed directly, as in JAX).
LAYERED_BY_FAMILY = {
    "llama": "LlamaForCausalLM",
    "gpt_neox": "GPTNeoXForCausalLM",
    "gptj": "GPTJForCausalLM",
    "opt": "OPTForCausalLM",
}

_LAYERED_CLASSES = {
    "LlamaForCausalLM": LlamaLayeredApply,
    "GPTNeoXForCausalLM": GPTNeoXLayeredApply,
    "GPTJForCausalLM": GPTJLayeredApply,
    "OPTForCausalLM": OPTLayeredApply,
}


def layered_for_family(family: str, config):
    """The family's `LayeredApply`, from its config alone."""
    cls_name = LAYERED_BY_FAMILY.get(family)
    if cls_name is None:
        raise ValueError(
            f"Family {family!r} ships no LayeredApply decomposition (known: {sorted(LAYERED_BY_FAMILY)})."
        )
    return _LAYERED_CLASSES[cls_name](config)


def layered_for_model(model):
    """The model's `LayeredApply`, by its module class; raises ValueError
    for a family without one."""
    module = getattr(model, "module", model)
    layered_cls = _LAYERED_CLASSES.get(type(module).__name__)
    if layered_cls is None:
        raise ValueError(
            f"No LayeredApply decomposition for module {type(module).__name__!r} "
            f"(known: {sorted(LAYERED_BY_FAMILY.values())}). Pass layered= explicitly."
        )
    return layered_cls(module.config)


def create_named_model(
    name: str, seed: int = 0, dtype: torch.dtype = torch.float32, device: DeviceLike = None
) -> nn.Module:
    """A registered model at its published widths, random weights from `seed`."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; expected one of {sorted(MODEL_REGISTRY)}")
    config = MODEL_REGISTRY[name]()
    return CREATE_BY_FAMILY[type(config)](config, seed=seed, dtype=dtype, device=device)


def get_model_family(name: str):
    """(interchange family, config) for a registered model name (JAX's
    `get_model_family`)."""
    key = name.lower()
    if key not in MODEL_REGISTRY:
        raise ValueError(f"Unknown in-tree model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    config = MODEL_REGISTRY[key]()
    return FAMILY_BY_CONFIG[type(config)], config


def state_dict_to_flax(state, config) -> dict:
    """The inverse of the family's ``*_state_dict_from_flax``: a `state_dict`
    (or a module) -> JAX's params tree ``{"params": {...}}`` of numpy-able
    tensors, per layer (``layer_{i}``). Each parameter's flax path and dim
    order come from `parallel.sharding.flax_view` on a skeleton of the
    family built on the meta device; a tied parameter appears once, under
    its first name, as in JAX's tree."""
    from ..parallel.sharding import flax_view

    if isinstance(state, nn.Module):
        state = state.state_dict()
    with torch.device("meta"):
        skeleton = MODULE_BY_CONFIG[type(config)](config)
    tree: dict = {}
    for view in flax_view(skeleton):
        parts = view.keys
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = state[view.name].detach().permute(*view.torch_dims).contiguous()
    return tree


def state_dict_from_flax(params, config) -> dict:
    """`state_dict_to_flax`'s inverse: JAX's per-layer params tree (tensors
    or arrays, bf16 tensors kept bit for bit) -> the port's `state_dict`,
    a tied parameter under each of its names. A scanned tree
    (``scan_layers=True``) goes through the family's own
    ``*_state_dict_from_flax``, which unstacks it."""
    from ..parallel.sharding import flax_view

    tree = params["params"] if "params" in params else params
    with torch.device("meta"):
        skeleton = MODULE_BY_CONFIG[type(config)](config)
    by_view = {}
    for view in flax_view(skeleton):
        node = tree
        for part in view.keys[1:]:
            if not isinstance(node, dict) or part not in node:
                raise KeyError(f"the params tree has no {view.path} (a {type(config).__name__} per-layer tree "
                               "is expected; a scanned one loads through the family's *_state_dict_from_flax)")
            node = node[part]
        leaf = torch.as_tensor(node) if not isinstance(node, torch.Tensor) else node
        inverse = [view.torch_dims.index(d) for d in range(len(view.torch_dims))]
        by_view[view.name] = leaf.permute(*inverse).contiguous()
    names = {id(p): n for n, p in skeleton.named_parameters()}
    return {name: by_view[names[id(t)]] for name, t in skeleton.state_dict(keep_vars=True).items()
            if id(t) in names}
