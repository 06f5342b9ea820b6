"""GPT-NeoX family decoder in PyTorch: the port of
`accelerate_tpu/models/gpt_neox.py` (GPT-NeoX-20B, the reference's
big-model-inference config).

A parallel residual ``x + attn(ln_1(x)) + mlp(ln_2(x))`` (or the sequential
one with ``use_parallel_residual=False``) with two LayerNorms per block;
partial rotary embeddings in Llama's half-split style on the first
``rotary_ndims`` dims of each head; biased q/k/v/out and MLP projections
with exact (erf) GELU; an untied head without bias (`embed_out`). Every
query head has its own K/V head (Hq = Hkv). Parameter names follow the
flax tree, so `gpt_neox_state_dict_from_flax` carries JAX weights across.

NeoX is the second family behind `slot_cache_attention`: the engine serves
it paged and contiguous, through the gather path and the K1/K2 kernels,
with int8 weights and int8/fp8 caches, as Llama; `generate` runs it over
the decode cache and training through `dot_product_attention`'s gate (the
flash kernels at NeoX-20B's head dim 96).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from .decoder import (
    CausalDecoder,
    DecoderAttention,
    DecoderLayeredApply,
    Dense,
    LayerNorm,
    random_init,
    state_dict_from_flax,
)
from .llama import rotary_embedding


#: JAX's Megatron table for the family (`accelerate_tpu/models/gpt_neox.py`'s GPT_NEOX_SHARDING_RULES):
#: `(path regex, PartitionSpec)` over the flax tree's paths, first match
#: wins. `parallel.sharding.spec_for_param` reads it on the flax view of
#: the port's parameters.
GPT_NEOX_SHARDING_RULES = [
    (r"(wq|wk|wv)/kernel", (None, "model")),
    (r"wo/kernel", ("model", None)),
    (r"dense_h_to_4h/kernel", (None, "model")),
    (r"dense_4h_to_h/kernel", ("model", None)),
    (r"embed_in/embedding", ("model", None)),
    (r"embed_out/kernel", (None, "model")),
]


@dataclass
class GPTNeoXConfig:
    """JAX's fields the port runs (its XLA-only `scan_layers` and
    `decode_tp_mesh`, and the serving fields its engine sets, are left
    out: the port's engine takes those as arguments)."""

    vocab_size: int = 50432
    hidden_size: int = 6144
    intermediate_size: int = 24576
    num_hidden_layers: int = 44
    num_attention_heads: int = 64
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_ndims(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads


def neox_partial_rotary(x, positions, rotary_ndims: int, theta: float):
    """NeoX RoPE on [B, S, H, D]: the first `rotary_ndims` dims of each head
    rotate in the half-split style (Llama's, in f32), the rest pass
    through."""
    rot = rotary_embedding(x[..., :rotary_ndims], positions, theta)
    return torch.cat([rot, x[..., rotary_ndims:]], dim=-1)


class GPTNeoXMLP(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig):
        super().__init__()
        self.dense_h_to_4h = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.dense_4h_to_h = Dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, hidden):
        return self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(hidden)))  # exact erf: NeoX's "gelu"


class GPTNeoXBlock(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig):
        super().__init__()
        self.parallel = cfg.use_parallel_residual
        self.input_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        rotary = partial(neox_partial_rotary, rotary_ndims=cfg.rotary_ndims, theta=cfg.rope_theta)
        self.attention = DecoderAttention(cfg.hidden_size, cfg.num_attention_heads, bias=True, rotary=rotary)
        self.post_attn_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = GPTNeoXMLP(cfg)

    def forward(self, hidden, positions, *modes):
        attn = self.attention(self.input_norm(hidden), positions, *modes)
        if self.parallel:
            return hidden + attn + self.mlp(self.post_attn_norm(hidden))
        hidden = hidden + attn
        return hidden + self.mlp(self.post_attn_norm(hidden))


class GPTNeoXForCausalLM(CausalDecoder):

    sharding_rules = GPT_NEOX_SHARDING_RULES
    #: Tensor parallel over "model" splits this family (`parallel.tensor`).
    tensor_parallel = True

    def __init__(self, cfg: GPTNeoXConfig):
        super().__init__()
        self.config = cfg
        self.embed_in = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(GPTNeoXBlock(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.embed_out = Dense(cfg.hidden_size, cfg.vocab_size, bias=False)

    def get_input_embeddings(self) -> nn.Embedding:
        return self.embed_in

    def head(self, hidden):
        return self.embed_out(hidden)


def create_gpt_neox_model(
    config: Optional[GPTNeoXConfig] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> GPTNeoXForCausalLM:
    """A GPT-NeoX with random weights drawn from `seed`, made in `dtype` on
    `device` (``cuda`` unless the caller passes ``device="cpu"``); see
    `decoder.random_init`. NeoX-20B is 41.1 GB in bf16 and 82 GB in f32."""
    config = config or gpt_neox_tiny()
    return random_init(lambda: GPTNeoXForCausalLM(config), seed, dtype, device)


def gpt_neox_state_dict_from_flax(params, config: GPTNeoXConfig):
    """The port's `state_dict` from a JAX GPT-NeoX params tree (numpy
    arrays), per-layer (``layer_{i}``) or scanned (``blocks``)."""
    return state_dict_from_flax(params, config.num_hidden_layers)


class GPTNeoXLayeredApply(DecoderLayeredApply):
    """GPT-NeoX streamed a layer at a time (JAX's `GPTNeoXLayeredApply`)."""

    model_cls = GPTNeoXForCausalLM
    PRELUDE = ("embed_in",)
    TAIL = ("final_norm", "embed_out")


def gpt_neox_20b() -> GPTNeoXConfig:
    """EleutherAI GPT-NeoX-20B dims (reference benchmarks/README.md:33)."""
    return GPTNeoXConfig()


def gpt_neox_tiny() -> GPTNeoXConfig:
    return GPTNeoXConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=2,
        num_attention_heads=4,
        max_position_embeddings=256,
    )
