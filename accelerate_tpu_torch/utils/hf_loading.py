"""HF checkpoint interchange: load Hugging Face checkpoints into the port's
models, and write them back.

Port of `accelerate_tpu/utils/hf_loading.py` for Llama, Mixtral, GPT-J,
GPT-NeoX, OPT and T5. The JAX package maps HF names
to a flax tree and transposes every torch ``[out, in]`` weight into a flax
``[in, out]`` kernel; the port's modules carry the flax tree's names as
their own state-dict names (``layers.0.attention.wq.weight``, what the
families' ``*_state_dict_from_flax`` produce) and store `nn.Linear`
weights as ``[out, in]`` as HF does, so a mapping here is a renaming,
except GPT-NeoX's fused ``query_key_value``, split per head and fused back,
and Mixtral's per-expert ``w1``/``w3``/``w2`` (``[out, in]`` each), stacked
into the experts' ``[E, in, out]`` weights and split back.

Files: a single ``.safetensors`` (read and written by `utils/modeling.py`,
no `safetensors` package), a torch ``.bin`` (`torch.load(weights_only=True)`),
or a directory with ``model.safetensors.index.json`` or
``pytorch_model.bin.index.json`` (sharded) or a single such file. Tensors
stay in the file's dtype until `load_hf_checkpoint_in_model` copies each
into the parameter it belongs to, so a bf16 model on the card stays bf16 on
the card and no f32 copy of a checkpoint is ever made.

A tied head: with ``tie_word_embeddings`` (Llama, T5 v1.0) and for OPT, the
head is the embedding. A checkpoint may leave the head out (safetensors
drops shared tensors) or carry it equal to the embedding (a ``.bin``'s or an
in-memory state dict's tied view); a head that differs from the embedding is
refused, where the JAX package drops it without a word.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Tuple

import torch
from torch import nn

from .modeling import load_safetensors_state_dict, save_safetensors

StateDict = Dict[str, torch.Tensor]


# --------------------------------------------------------------------- file readers
def _read_torch_bin(path: str) -> StateDict:
    try:
        state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except RuntimeError:  # a file of torch's legacy (pre-zip) format cannot be mapped
        state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach() for k, v in state.items()}


def load_hf_state_dict(path: str) -> StateDict:
    """Flat name -> CPU tensor, in the file's dtype, from a checkpoint file,
    a sharded-index directory or a directory holding one checkpoint file."""
    if os.path.isdir(path):
        for index_name, reader in (("model.safetensors.index.json", load_safetensors_state_dict),
                                   ("pytorch_model.bin.index.json", _read_torch_bin)):
            index = os.path.join(path, index_name)
            if os.path.exists(index):
                with open(index) as f:
                    weight_map = json.load(f)["weight_map"]
                state: StateDict = {}
                for shard in sorted(set(weight_map.values())):
                    state.update(reader(os.path.join(path, shard)))
                return state
        for name in ("model.safetensors", "pytorch_model.bin"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                return load_hf_state_dict(p)
        raise FileNotFoundError(f"No checkpoint found in {path}")
    if path.endswith(".safetensors"):
        return load_safetensors_state_dict(path)
    return _read_torch_bin(path)


# ----------------------------------------------------------------------- shared
Pairs = List[Tuple[str, str]]  # (HF name, the port's name)


def _rename_from(flat: Mapping[str, torch.Tensor], pairs: Pairs) -> StateDict:
    return {ours: torch.as_tensor(flat[hf]) for hf, ours in pairs}


def _rename_to(state: Mapping[str, torch.Tensor], pairs: Pairs) -> StateDict:
    return {hf: state[ours] for hf, ours in pairs}


def _refuse_distinct_head(flat, head: str, embedding: str):
    """A tied model's head is its embedding: a checkpoint head equal to it
    (or absent) is accepted, a distinct one refused."""
    if head in flat and not torch.equal(torch.as_tensor(flat[head]), torch.as_tensor(flat[embedding])):
        raise ValueError(
            f"tie_word_embeddings=True but the checkpoint carries a {head} distinct from {embedding}; "
            "refusing to drop it (load it with an untied config)"
        )


def _pairs(pre_hf: str, pre_ours: str, names) -> Pairs:
    return [(pre_hf + hf, pre_ours + ours) for hf, ours in names]


def _weights(names) -> List[Tuple[str, str]]:
    return [(hf + ".weight", ours + ".weight") for hf, ours in names]


def _weights_and_biases(names) -> List[Tuple[str, str]]:
    return [(hf + suffix, ours + suffix) for hf, ours in names for suffix in (".weight", ".bias")]


# -------------------------------------------------------------------------- llama
def _llama_pairs(config) -> Pairs:
    pairs = [("model.embed_tokens.weight", "embed_tokens.weight"), ("model.norm.weight", "final_norm.weight")]
    for i in range(config.num_hidden_layers):
        pairs += _pairs(f"model.layers.{i}.", f"layers.{i}.", _weights(
            [(f"self_attn.{x}_proj", f"attention.w{x}") for x in "qkvo"]
            + [(f"mlp.{x}_proj", f"mlp.w_{x}") for x in ("gate", "up", "down")]
            + [("input_layernorm", "input_norm"), ("post_attention_layernorm", "post_attn_norm")]
        ))
    if not config.tie_word_embeddings:
        pairs.append(("lm_head.weight", "lm_head.weight"))
    return pairs


def _llama_from_hf(flat, config) -> StateDict:
    if config.tie_word_embeddings:
        _refuse_distinct_head(flat, "lm_head.weight", "model.embed_tokens.weight")
    return _rename_from(flat, _llama_pairs(config))


def _llama_to_hf(state, config) -> StateDict:
    return _rename_to(state, _llama_pairs(config))


# ------------------------------------------------------------------------ mixtral
#: HF's expert projections -> the port's expert weights (w1 gate, w3 up, w2 down).
_MIXTRAL_EXPERTS = (("w1", "w_gate"), ("w3", "w_up"), ("w2", "w_down"))


def _mixtral_pairs(config) -> Pairs:
    """Every name but the experts' weights; the router is ``gate``."""
    pairs = [("model.embed_tokens.weight", "embed_tokens.weight"), ("model.norm.weight", "final_norm.weight"),
             ("lm_head.weight", "lm_head.weight")]
    for i in range(config.num_hidden_layers):
        pairs += _pairs(f"model.layers.{i}.", f"layers.{i}.", _weights(
            [(f"self_attn.{x}_proj", f"attention.w{x}") for x in "qkvo"]
            + [("block_sparse_moe.gate", "moe.router")]
            + [("input_layernorm", "input_norm"), ("post_attention_layernorm", "post_attn_norm")]
        ))
    return pairs


def _mixtral_from_hf(flat, config) -> StateDict:
    """Each expert's ``[out, in]`` projection transposed and stacked over
    the experts into ``[E, in, out]``."""
    state = _rename_from(flat, _mixtral_pairs(config))
    for i in range(config.num_hidden_layers):
        p = f"model.layers.{i}.block_sparse_moe.experts."
        for hf, ours in _MIXTRAL_EXPERTS:
            state[f"layers.{i}.moe.experts.{ours}"] = torch.stack(
                [torch.as_tensor(flat[f"{p}{e}.{hf}.weight"]).T for e in range(config.num_local_experts)])
    return state


def _mixtral_to_hf(state, config) -> StateDict:
    flat = _rename_to(state, _mixtral_pairs(config))
    for i in range(config.num_hidden_layers):
        p = f"model.layers.{i}.block_sparse_moe.experts."
        for hf, ours in _MIXTRAL_EXPERTS:
            stacked = state[f"layers.{i}.moe.experts.{ours}"]
            for e in range(config.num_local_experts):
                flat[f"{p}{e}.{hf}.weight"] = stacked[e].T.contiguous()
    return flat


# --------------------------------------------------------------------------- gptj
def _gptj_pairs(config) -> Pairs:
    pairs = [("transformer.wte.weight", "wte.weight")]
    pairs += _weights_and_biases([("transformer.ln_f", "ln_f"), ("lm_head", "lm_head")])
    for i in range(config.num_hidden_layers):
        pairs += _pairs(f"transformer.h.{i}.", f"layers.{i}.",
                        _weights([(f"attn.{x}_proj", f"attention.w{x}") for x in "qkv"]
                                 + [("attn.out_proj", "attention.wo")])
                        + _weights_and_biases([("ln_1", "ln_1"), ("mlp.fc_in", "mlp.fc_in"),
                                               ("mlp.fc_out", "mlp.fc_out")]))
    return pairs


def _gptj_from_hf(flat, config) -> StateDict:
    return _rename_from(flat, _gptj_pairs(config))


def _gptj_to_hf(state, config) -> StateDict:
    return _rename_to(state, _gptj_pairs(config))


# ----------------------------------------------------------------------- gpt_neox
def _gpt_neox_pairs(config) -> Pairs:
    """Every name but the fused query_key_value."""
    pairs = [("gpt_neox.embed_in.weight", "embed_in.weight"), ("embed_out.weight", "embed_out.weight")]
    pairs += _weights_and_biases([("gpt_neox.final_layer_norm", "final_norm")])
    for i in range(config.num_hidden_layers):
        pairs += _pairs(f"gpt_neox.layers.{i}.", f"layers.{i}.", _weights_and_biases([
            ("input_layernorm", "input_norm"), ("post_attention_layernorm", "post_attn_norm"),
            ("attention.dense", "attention.wo"), ("mlp.dense_h_to_4h", "mlp.dense_h_to_4h"),
            ("mlp.dense_4h_to_h", "mlp.dense_4h_to_h"),
        ]))
    return pairs


def _gpt_neox_from_hf(flat, config) -> StateDict:
    """HF fuses Q, K and V as ``query_key_value`` with a per-head ``[h, 3,
    d]`` output layout: split by viewing the weight ``[3H, H]`` as ``[h, 3,
    d, H]`` (the bias as ``[h, 3, d]``)."""
    h, d, hidden = config.num_attention_heads, config.head_dim, config.hidden_size
    state = _rename_from(flat, _gpt_neox_pairs(config))
    for i in range(config.num_hidden_layers):
        p = f"gpt_neox.layers.{i}.attention.query_key_value."
        w = torch.as_tensor(flat[p + "weight"]).reshape(h, 3, d, hidden)
        b = torch.as_tensor(flat[p + "bias"]).reshape(h, 3, d)
        for j, name in enumerate(("wq", "wk", "wv")):
            state[f"layers.{i}.attention.{name}.weight"] = w[:, j].reshape(h * d, hidden)
            state[f"layers.{i}.attention.{name}.bias"] = b[:, j].reshape(h * d)
    return state


def _gpt_neox_to_hf(state, config) -> StateDict:
    """The inverse: Q, K and V fused back into HF's per-head layout."""
    h, d, hidden = config.num_attention_heads, config.head_dim, config.hidden_size
    flat = _rename_to(state, _gpt_neox_pairs(config))
    for i in range(config.num_hidden_layers):
        ours = f"layers.{i}.attention."
        w = torch.stack([state[ours + f"{x}.weight"].reshape(h, d, hidden) for x in ("wq", "wk", "wv")], dim=1)
        b = torch.stack([state[ours + f"{x}.bias"].reshape(h, d) for x in ("wq", "wk", "wv")], dim=1)
        p = f"gpt_neox.layers.{i}.attention.query_key_value."
        flat[p + "weight"] = w.reshape(3 * hidden, hidden)
        flat[p + "bias"] = b.reshape(3 * hidden)
    return flat


# ---------------------------------------------------------------------------- opt
def _opt_pairs(config) -> Pairs:
    pairs = [("model.decoder.embed_tokens.weight", "embed_tokens.weight"),
             ("model.decoder.embed_positions.weight", "embed_positions.weight")]
    pairs += _weights_and_biases([("model.decoder.final_layer_norm", "final_norm")])
    for i in range(config.num_hidden_layers):
        pairs += _pairs(f"model.decoder.layers.{i}.", f"layers.{i}.", _weights_and_biases(
            [("self_attn_layer_norm", "self_attn_norm"), ("final_layer_norm", "final_norm"),
             ("fc1", "fc1"), ("fc2", "fc2")]
            + [(f"self_attn.{x}_proj", f"attention.w{x}") for x in "qkv"]
            + [("self_attn.out_proj", "attention.wo")]
        ))
    return pairs


def _opt_from_hf(flat, config) -> StateDict:
    _refuse_distinct_head(flat, "lm_head.weight", "model.decoder.embed_tokens.weight")
    return _rename_from(flat, _opt_pairs(config))


def _opt_to_hf(state, config) -> StateDict:
    flat = _rename_to(state, _opt_pairs(config))
    flat["lm_head.weight"] = state["embed_tokens.weight"]  # tied
    return flat


# ----------------------------------------------------------------------------- t5
def _t5_pairs(config, gated: bool) -> Pairs:
    """HF's per-stack blocks with numbered sublayers (0 self-attention, 1
    cross-attention in the decoder, the last the FFN); the relative-bias
    table lives on block 0 of each stack, one table per stack in the port."""
    ff = ([("wi_0", "wi_0"), ("wi_1", "wi_1")] if gated else [("wi", "wi")]) + [("wo", "wo_ff")]

    def attn(hf, ours):
        return [(f"{hf}.{x}", f"{ours}.w{x}") for x in "qkvo"]

    pairs = [("shared.weight", "shared.weight")]
    pairs += _weights([
        ("encoder.final_layer_norm", "enc_final_norm"), ("decoder.final_layer_norm", "dec_final_norm"),
        ("encoder.block.0.layer.0.SelfAttention.relative_attention_bias", "enc_bias"),
        ("decoder.block.0.layer.0.SelfAttention.relative_attention_bias", "dec_bias"),
    ])
    if not config.tie_word_embeddings:
        pairs.append(("lm_head.weight", "lm_head.weight"))
    for i in range(config.num_layers):
        pairs += _pairs(f"encoder.block.{i}.", f"enc_blocks.{i}.", _weights(
            attn("layer.0.SelfAttention", "attention") + [("layer.0.layer_norm", "input_norm")]
            + [(f"layer.1.DenseReluDense.{hf}", f"ff.{ours}") for hf, ours in ff]
            + [("layer.1.layer_norm", "ff_norm")]
        ))
    for i in range(config.num_decoder_layers):
        pairs += _pairs(f"decoder.block.{i}.", f"dec_blocks.{i}.", _weights(
            attn("layer.0.SelfAttention", "self_attention") + [("layer.0.layer_norm", "input_norm")]
            + attn("layer.1.EncDecAttention", "cross_attention") + [("layer.1.layer_norm", "cross_norm")]
            + [(f"layer.2.DenseReluDense.{hf}", f"ff.{ours}") for hf, ours in ff]
            + [("layer.2.layer_norm", "ff_norm")]
        ))
    return pairs


def _t5_from_hf(flat, config) -> StateDict:
    """Both generations load: v1.1 (untied head, gated wi_0/wi_1: t5-v1_1-*,
    T0pp, flan-t5) and v1.0 (head tied to the shared embedding, one relu
    `wi`: t5-small/base/large). The FFN keys name the checkpoint's
    generation; the config must name the same one. Head-tying comes from the
    config: a ``.bin`` keeps a tied ``lm_head.weight`` view while
    safetensors drops shared tensors, so the head's presence proves nothing."""
    ckpt_gated = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in flat
    cfg_gated = getattr(config, "feed_forward_proj", "gated-gelu") != "relu"
    cfg_tied = bool(getattr(config, "tie_word_embeddings", False))
    if ckpt_gated != cfg_gated:
        raise ValueError(
            f"T5 checkpoint/config generation mismatch: checkpoint has a "
            f"{'gated wi_0/wi_1 (v1.1)' if ckpt_gated else 'single relu wi (v1.0)'} "
            f"FFN but the config says feed_forward_proj="
            f"{getattr(config, 'feed_forward_proj', 'gated-gelu')!r}. Use a "
            f"t5_small_v1_0()-style config (tie_word_embeddings=True, relu) for "
            f"v1.0 checkpoints (t5-small/base/large) and the default T5Config "
            f"for v1.1 (t5-v1_1-*, T0pp, flan-t5)."
        )
    if not cfg_tied and "lm_head.weight" not in flat:
        raise ValueError(
            "config says tie_word_embeddings=False but the checkpoint has no "
            "lm_head.weight — this is a tied-head (v1.0) checkpoint; load it "
            "with a tie_word_embeddings=True config (e.g. t5_small_v1_0())."
        )
    if cfg_tied:
        _refuse_distinct_head(flat, "lm_head.weight", "shared.weight")
    return _rename_from(flat, _t5_pairs(config, ckpt_gated))


def _t5_to_hf(state, config) -> StateDict:
    flat = _rename_to(state, _t5_pairs(config, config.feed_forward_proj != "relu"))
    flat["encoder.embed_tokens.weight"] = flat["decoder.embed_tokens.weight"] = state["shared.weight"]
    return flat


_FROM_HF = {
    "llama": _llama_from_hf,
    "mixtral": _mixtral_from_hf,
    "gptj": _gptj_from_hf,
    "gpt_neox": _gpt_neox_from_hf,
    "opt": _opt_from_hf,
    "t5": _t5_from_hf,
}
_TO_HF = {
    "llama": _llama_to_hf,
    "mixtral": _mixtral_to_hf,
    "gptj": _gptj_to_hf,
    "gpt_neox": _gpt_neox_to_hf,
    "opt": _opt_to_hf,
    "t5": _t5_to_hf,
}


def _module_of(model) -> nn.Module:
    """The `nn.Module` of a module, a `Model` bundle or a `PreparedModel`."""
    return model if isinstance(model, nn.Module) else model.module


def convert_hf_state_dict(flat: Mapping[str, torch.Tensor], model_type: str, config) -> StateDict:
    """Flat HF state dict -> the port's `state_dict` for `model_type`."""
    if model_type not in _FROM_HF:
        raise ValueError(f"Unsupported model_type {model_type!r}; known: {sorted(_FROM_HF)}")
    return _FROM_HF[model_type](flat, config)


def export_hf_state_dict(state, model_type: str, config) -> StateDict:
    """The port's `state_dict` (or a model) -> flat HF-layout state dict
    (torch ``[out, in]`` weights), tensors on the model's device."""
    if model_type not in _TO_HF:
        raise ValueError(f"Unsupported model_type {model_type!r}; known: {sorted(_TO_HF)}")
    if not isinstance(state, Mapping):
        state = _module_of(state).state_dict()
    return _TO_HF[model_type](state, config)


def load_hf_checkpoint_in_model(model, checkpoint_path: str, model_type: str, config=None):
    """Load an HF checkpoint into `model` (a module, `Model` or
    `PreparedModel`) in place, every tensor copied into the parameter it
    belongs to (`load_state_dict(strict=True)`): the parameters keep their
    dtype and device. Returns the model."""
    module = _module_of(model)
    config = config or getattr(module, "config", None)
    if config is None:
        raise ValueError("Pass config= when the model has no config")
    state = convert_hf_state_dict(load_hf_state_dict(checkpoint_path), model_type, config)
    module.load_state_dict(state, strict=True)
    return model


def save_hf_checkpoint(state_or_model, model_type: str, config, save_path: str):
    """Write a model (or its `state_dict`) as one HF-layout .safetensors
    file, each tensor in its own dtype (bf16 as BF16)."""
    flat = export_hf_state_dict(state_or_model, model_type, config)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    save_safetensors(flat, save_path, metadata={"format": "pt"})
