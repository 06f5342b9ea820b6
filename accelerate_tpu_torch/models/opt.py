"""OPT family decoder in PyTorch: the port of `accelerate_tpu/models/opt.py`
(OPT-30B, the reference's big-model-inference config).

Pre-LN blocks (``do_layer_norm_before``, every OPT from 350m on) with
biased q/k/v/out and `fc1`/`fc2`, ReLU; learned position embeddings looked
up at ``position + POSITION_OFFSET`` (fairseq's legacy offset of 2, the
table has ``max_position_embeddings + 2`` rows); the head tied to the
token embedding. A left-padded `generate` passes the positions of JAX's,
``clip(cumsum(mask) - 1, 0)``, so a row's first real token sits at
position 0 whatever its padding.

The JAX block names its second norm ``final_norm``, as the model names its
last one; the port keeps both names, ``layers.{i}.final_norm`` and
``final_norm``, so the flax tree carries across by path.

The JAX module has no slot cache, so the engine refuses OPT, as JAX's
does; `generate` and training run it (the flash kernels at head dim 128).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from .decoder import CausalDecoder, DecoderAttention, Dense, LayerNorm, random_init, state_dict_from_flax

POSITION_OFFSET = 2


@dataclass
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 7168
    intermediate_size: int = 28672
    num_hidden_layers: int = 48
    num_attention_heads: int = 56
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads


class OPTBlock(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.self_attn_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.attention = DecoderAttention(cfg.hidden_size, cfg.num_attention_heads, bias=True)
        self.final_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, hidden, positions, *modes):
        hidden = hidden + self.attention(self.self_attn_norm(hidden), positions, *modes)
        return hidden + self.fc2(F.relu(self.fc1(self.final_norm(hidden))))


class OPTForCausalLM(CausalDecoder):
    slot_serving = False

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings + POSITION_OFFSET, cfg.hidden_size)
        self.layers = nn.ModuleList(OPTBlock(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def get_input_embeddings(self) -> nn.Embedding:
        return self.embed_tokens

    def embed(self, input_ids, positions):
        return self.embed_tokens(input_ids) + self.embed_positions(positions + POSITION_OFFSET)

    def head(self, hidden):
        return hidden @ self.embed_tokens.weight.T.to(hidden.dtype)  # tied


def create_opt_model(
    config: Optional[OPTConfig] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> OPTForCausalLM:
    """An OPT with random weights drawn from `seed`, made in `dtype` on
    `device` (``cuda`` unless ``device="cpu"``); see `decoder.random_init`.
    The embeddings' std is 1/sqrt(hidden), so the tied head's logits start
    near unit scale. OPT-30B is 59.9 GB in bf16."""
    config = config or opt_tiny()
    return random_init(lambda: OPTForCausalLM(config), seed, dtype, device, embed_std=config.hidden_size ** -0.5)


def opt_state_dict_from_flax(params, config: OPTConfig):
    """The port's `state_dict` from a JAX OPT params tree (numpy arrays),
    per-layer or scanned; a block's ``final_norm`` and the model's stay
    apart by their paths."""
    return state_dict_from_flax(params, config.num_hidden_layers)


def opt_30b() -> OPTConfig:
    """facebook/opt-30b dims (reference benchmarks/README.md:36)."""
    return OPTConfig()


def opt_tiny() -> OPTConfig:
    return OPTConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=2,
        num_attention_heads=4,
        max_position_embeddings=256,
    )
