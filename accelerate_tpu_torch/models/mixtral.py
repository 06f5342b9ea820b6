"""Mixtral-family sparse-MoE decoder in PyTorch: the port of
`accelerate_tpu/models/mixtral.py`.

Llama's backbone (RMSNorm, rotary embeddings over split halves, grouped-query
attention: the port's `models/llama.py` modules over Llama's view of the
config, `MixtralConfig.as_llama`) with the top-k `MoEBlock` of
`parallel/expert.py` in place of the MLP. Each layer returns its router
losses beside its hidden state; `CausalDecoder.forward(..., return_aux=True)`
averages them over the layers, and `make_moe_causal_lm_loss` adds them to
the cross-entropy: ``ce + 0.02 * load_balance + 0.001 * z``, returned as
``(loss, {"ce", "load_balance_loss", "router_z_loss"})``, which
`Accelerator.backward` and the fused `train_step` pass through.

Parameter names follow the flax tree (``layers.0.moe.router.weight``,
``layers.0.moe.experts.w_gate`` for ``experts/w_gate/kernel``), so
`mixtral_state_dict_from_flax` carries JAX weights across key for key.

The JAX module has no slot cache, so the engine refuses Mixtral, as JAX's
does; `generate` and the static `Generator` run it over the decode cache
(no K1-K5: masked or one-row attention, as JAX's), routing the tokens of
each forward with that forward's capacity; training reaches the flash
kernels through `dot_product_attention`'s gate (head dim 128 at 8x7B).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike
from ..parallel.expert import MoEBlock
from .decoder import CausalDecoder, random_init, state_dict_from_flax
from .llama import LlamaAttention, LlamaConfig, RMSNorm


@dataclass
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    max_position_embeddings: int = 32768
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-5
    router_aux_loss_coef: float = 0.02
    router_z_loss_coef: float = 0.001

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def as_llama(self) -> LlamaConfig:
        """Llama's view of the config, for the shared attention modules."""
        return LlamaConfig(
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rope_theta=self.rope_theta,
            rms_norm_eps=self.rms_norm_eps,
        )


class MixtralLayer(nn.Module):
    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attention = LlamaAttention(cfg.as_llama())
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.moe = MoEBlock(cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts, cfg.num_experts_per_tok,
                            cfg.capacity_factor)

    def forward(self, hidden, positions, *modes):
        hidden = hidden + self.attention(self.input_norm(hidden), positions, *modes)
        moe_out, aux = self.moe(self.post_attn_norm(hidden))
        return hidden + moe_out, aux


def make_moe_causal_lm_loss(config: MixtralConfig):
    """Next-token cross-entropy plus the router losses (the Mixtral
    objective), ``loss_fn(batch, apply_fn) -> (loss, aux)``: labels < 0 are
    ignored and default to the inputs, as in `causal_lm_loss`."""

    def moe_causal_lm_loss(batch, apply_fn):
        logits, aux = apply_fn(batch["input_ids"], batch.get("attention_mask"), return_aux=True)
        labels = batch.get("labels", batch["input_ids"])
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        shift_labels = labels[:, 1:].long()
        valid = (shift_labels >= 0).float()
        nll = -torch.gather(logp, -1, shift_labels.clamp_min(0)[..., None])[..., 0]
        ce = (nll * valid).sum() / valid.sum().clamp_min(1.0)
        total = (ce + config.router_aux_loss_coef * aux["load_balance_loss"]
                 + config.router_z_loss_coef * aux["router_z_loss"])
        return total, {"ce": ce, **aux}

    return moe_causal_lm_loss


class MixtralForCausalLM(CausalDecoder):
    """`CausalDecoder.forward` over Mixtral's layers, with an untied
    `lm_head`; its `loss_fn` is `make_moe_causal_lm_loss(config)`, as
    JAX's `create_mixtral_model` bundles it."""

    slot_serving = False

    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        self.config = cfg
        self.loss_fn = make_moe_causal_lm_loss(cfg)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(MixtralLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def get_input_embeddings(self) -> nn.Embedding:
        return self.embed_tokens

    def head(self, hidden):
        return self.lm_head(hidden)


def create_mixtral_model(
    config: Optional[MixtralConfig] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> MixtralForCausalLM:
    """A Mixtral with random weights drawn from `seed`, made in `dtype` on
    `device` (``cuda`` unless ``device="cpu"``); see `decoder.random_init`."""
    config = config or mixtral_tiny()
    return random_init(lambda: MixtralForCausalLM(config), seed, dtype, device)


def mixtral_state_dict_from_flax(params, config: MixtralConfig):
    """The port's `state_dict` from a JAX Mixtral params tree (numpy
    arrays); refuses a tree of another depth than the config's."""
    return state_dict_from_flax(params, config.num_hidden_layers)


def mixtral_8x7b() -> MixtralConfig:
    return MixtralConfig()


def mixtral_tiny() -> MixtralConfig:
    """Test-size config."""
    return MixtralConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        num_local_experts=4,
        num_experts_per_tok=2,
        max_position_embeddings=256,
        rope_theta=10000.0,
    )
