"""GPT-J family decoder in PyTorch: the port of `accelerate_tpu/models/gptj.py`
(GPT-J-6B, the reference's big-model-inference headline).

A parallel residual ``x + attn(ln(x)) + mlp(ln(x))`` with one LayerNorm
feeding both branches; partial rotary embeddings on the first
`rotary_dim` dims of each head with GPT-J's interleaved pairs
(`rotate_every_two`, not Llama's halves); bias-free q/k/v/out, a biased
MLP with tanh GELU (flax's default) and a biased `lm_head`. Parameter
names follow the flax tree (`wte`, `ln_1`, `fc_in`, `fc_out`, `ln_f`).

The JAX module has no slot cache, so the engine refuses GPT-J, as JAX's
does; `generate` runs it over the decode cache and training through
`dot_product_attention`'s gate (the flash kernels at head dim 256).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from .decoder import CausalDecoder, DecoderAttention, Dense, LayerNorm, random_init, state_dict_from_flax


@dataclass
class GPTJConfig:
    vocab_size: int = 50400
    hidden_size: int = 4096
    intermediate_size: int = 16384
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    rotary_dim: int = 64
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads


def partial_rotary(x, positions, rotary_dim: int):
    """GPT-J RoPE on [B, S, H, D]: the first `rotary_dim` dims of each head
    rotate as interleaved (even, odd) pairs, in f32; the rest pass
    through."""
    rot = x[..., :rotary_dim].float()
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=x.device) / rotary_dim))
    angles = positions[..., None].float() * inv_freq  # [B, S, rot/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = rot[..., ::2], rot[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(rot.shape)
    return torch.cat([out.to(x.dtype), x[..., rotary_dim:]], dim=-1)


class GPTJMLP(nn.Module):
    def __init__(self, cfg: GPTJConfig):
        super().__init__()
        self.fc_in = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.fc_out = Dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, hidden):
        return self.fc_out(F.gelu(self.fc_in(hidden), approximate="tanh"))


class GPTJBlock(nn.Module):
    def __init__(self, cfg: GPTJConfig):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        rotary = partial(partial_rotary, rotary_dim=cfg.rotary_dim)
        self.attention = DecoderAttention(cfg.hidden_size, cfg.num_attention_heads, bias=False, rotary=rotary)
        self.mlp = GPTJMLP(cfg)

    def forward(self, hidden, positions, *modes):
        normed = self.ln_1(hidden)
        return hidden + self.attention(normed, positions, *modes) + self.mlp(normed)


class GPTJForCausalLM(CausalDecoder):
    slot_serving = False

    def __init__(self, cfg: GPTJConfig):
        super().__init__()
        self.config = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(GPTJBlock(cfg) for _ in range(cfg.num_hidden_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size)  # biased, per GPT-J

    @property
    def final_norm(self):
        return self.ln_f

    def get_input_embeddings(self) -> nn.Embedding:
        return self.wte

    def head(self, hidden):
        return self.lm_head(hidden)


def create_gptj_model(
    config: Optional[GPTJConfig] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> GPTJForCausalLM:
    """A GPT-J with random weights drawn from `seed`, made in `dtype` on
    `device` (``cuda`` unless ``device="cpu"``); see `decoder.random_init`."""
    config = config or gptj_tiny()
    return random_init(lambda: GPTJForCausalLM(config), seed, dtype, device)


def gptj_state_dict_from_flax(params, config: GPTJConfig):
    """The port's `state_dict` from a JAX GPT-J params tree (numpy arrays),
    per-layer or scanned."""
    return state_dict_from_flax(params, config.num_hidden_layers)


def gptj_6b() -> GPTJConfig:
    """EleutherAI GPT-J-6B dims (the reference's benchmarks/README.md:31)."""
    return GPTJConfig()


def gptj_tiny() -> GPTJConfig:
    """Test-size config."""
    return GPTJConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=2,
        num_attention_heads=4,
        rotary_dim=16,
        max_position_embeddings=256,
    )
