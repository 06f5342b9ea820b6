"""Llama-family decoder in PyTorch: the port of `accelerate_tpu/models/llama.py`.

RMSNorm with fp32 accumulation, rotary embeddings over split halves computed
in fp32, grouped-query attention through `ops/attention.py`, SwiGLU MLP.
Parameter names follow the flax tree (`wq`, `input_norm`, `w_gate`, ...), so
`llama_state_dict_from_flax` carries JAX weights across key for key.

The attention module serves four modes, chosen by its arguments:
  - the full causal forward (no caches), the training path, with an
    optional [B, S] padding mask; long unmasked sequences reach the flash
    kernels through `dot_product_attention`'s gate;
  - the cached prefill (`kv_cache`): the prompt (or its unmatched suffix) as
    queries, written at its absolute positions into a dense per-slot K/V
    view and attended there (`dense_cache_attention`); the paged engine
    gathers that view from the pool and scatters it back, the contiguous
    engine passes the slot's own row (`generation.py`);
  - decode and verify through `slot_cache_attention` (`kv_pools`), with the
    engine's ``attention_impl``: paged pools with a page table, or the
    contiguous layout's [S, L, Hkv, D] rows without one;
  - the static `Generator`'s decode cache (`decode_cache`, JAX's
    ``decode_cache_length`` branch): one write index shared by the batch,
    a persistent pad mask, the plain masked attention over the written
    prefix (`ops.attention.decode_cache_attention`).

The layer loop goes through `ops.remat.maybe_remat`, so a `remat_scope`
(`CompilationConfig.remat_policy`) checkpoints every layer of a training
forward; the flash forward then runs again in the backward.

Quantized serving needs no config field: the engine decides. A layer's pool
entry carries the scale pools when the pool is int8 or fp8 (JAX's
`decode_kv_cache_dtype`), and the engine's copy of the model holds
`Int8Linear` layers when the weights are int8 (JAX's `weight_dtype`), both
from `ContinuousBatcher(kv_cache_dtype=..., weight_dtype=...)`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, make_generator, resolve_device
from ..parallel.tensor import attend_heads, tied_logits
from .decoder import CausalDecoder, DecoderLayeredApply, causal_lm_loss  # noqa: F401  (causal_lm_loss: JAX's home for it)


#: JAX's Megatron table for the family (`accelerate_tpu/models/llama.py`'s LLAMA_SHARDING_RULES):
#: `(path regex, PartitionSpec)` over the flax tree's paths, first match
#: wins. `parallel.sharding.spec_for_param` reads it on the flax view of
#: the port's parameters.
LLAMA_SHARDING_RULES = [
    (r"(wq|wk|wv)/kernel", (None, "model")),
    (r"wo/kernel", ("model", None)),
    (r"(w_gate|w_up)/kernel", (None, "model")),
    (r"w_down/kernel", ("model", None)),
    (r"embed_tokens/embedding", ("model", None)),
    (r"lm_head/kernel", (None, "model")),
]


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def rotary_embedding(x, positions, theta: float):
    """Apply RoPE to [B, S, H, D] given [B, S] positions: the two halves of
    the head dim rotate together (not interleaved pairs), in fp32."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., None].float() * inv_freq  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, hidden: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.weight.float()).to(x.dtype)


def _linear(n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.wq = _linear(cfg.hidden_size, hq * d)
        self.wk = _linear(cfg.hidden_size, hkv * d)
        self.wv = _linear(cfg.hidden_size, hkv * d)
        self.wo = _linear(hq * d, cfg.hidden_size)

    def forward(self, hidden, positions, attention_mask=None, kv_pool=None, page_table=None,
                attention_impl="gather", kv_cache=None, decode_cache=None):
        """`decode_cache` is ``(cache, layer index)``; `attention_mask` is
        then the block's decode mask (`decode_cache_mask`)."""
        cfg = self.cfg
        b, s, _ = hidden.shape
        d = cfg.head_dim
        # The head counts are the projections' (a tensor-parallel rank's
        # wq holds its query heads, wk and wv its KV heads).
        q = rotary_embedding(self.wq(hidden).reshape(b, s, -1, d), positions, cfg.rope_theta)
        k = rotary_embedding(self.wk(hidden).reshape(b, s, -1, d), positions, cfg.rope_theta)
        v = self.wv(hidden).reshape(b, s, -1, d)
        out = attend_heads(self, q, k, v, positions, attention_mask, kv_pool, page_table, attention_impl, kv_cache,
                           decode_cache)
        return self.wo(out.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.w_gate = _linear(cfg.hidden_size, cfg.intermediate_size)
        self.w_up = _linear(cfg.hidden_size, cfg.intermediate_size)
        self.w_down = _linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, hidden):
        return self.w_down(nn.functional.silu(self.w_gate(hidden)) * self.w_up(hidden))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attention = LlamaAttention(cfg)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, hidden, positions, attention_mask=None, kv_pool=None, page_table=None,
                attention_impl="gather", kv_cache=None, decode_cache=None):
        hidden = hidden + self.attention(
            self.input_norm(hidden), positions, attention_mask, kv_pool, page_table, attention_impl,
            kv_cache, decode_cache,
        )
        return hidden + self.mlp(self.post_attn_norm(hidden))


class LlamaForCausalLM(CausalDecoder):
    """`CausalDecoder.forward` over Llama's layers; the head is `lm_head`, or
    the embedding when `tie_word_embeddings`. Its `loss_fn` is
    `causal_lm_loss`, as JAX's `create_llama_model` bundles it."""

    sharding_rules = LLAMA_SHARDING_RULES
    #: Tensor parallel over "model" splits this family (`parallel.tensor`).
    tensor_parallel = True

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = None if cfg.tie_word_embeddings else _linear(cfg.hidden_size, cfg.vocab_size)

    def get_input_embeddings(self) -> nn.Embedding:
        return self.embed_tokens

    def head(self, hidden):
        if self.lm_head is None:
            return tied_logits(self.embed_tokens, hidden)
        return self.lm_head(hidden)


@torch.no_grad()
def create_llama_model(
    config: Optional[LlamaConfig] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> LlamaForCausalLM:
    """A Llama with random weights drawn from `seed` on `device` (``cuda``
    unless the caller passes ``device="cpu"``). Linear weights are normal
    with std 1/sqrt(fan_in), embeddings standard normal, norms ones. The
    modules are built without storage and filled from one explicit
    generator, so the global RNG is never drawn."""
    dev = resolve_device(device)
    config = config or llama_tiny()
    with torch.device("meta"):
        model = LlamaForCausalLM(config)
    model = model.to_empty(device=dev)
    gen = make_generator(seed, dev)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            module.weight.normal_(0.0, module.in_features ** -0.5, generator=gen)
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0, generator=gen)
        elif isinstance(module, RMSNorm):
            module.weight.fill_(1.0)
    return model.to(dtype).eval()


def llama_state_dict_from_flax(params, config: LlamaConfig):
    """The port's `state_dict` from a JAX Llama params tree given as numpy
    arrays (``{"params": {"embed_tokens": ..., "layer_0": ..., ...}}``).

    Flax `Dense` kernels are [in, out]; `nn.Linear` weights are [out, in], so
    every kernel is transposed. A ``scan_layers=True`` tree (one stacked
    ``layers/layer`` subtree) is unstacked along its leading axis. With
    ``tie_word_embeddings`` the head is the embedding and a distinct
    ``lm_head`` in the tree is an error; without it ``lm_head`` is required."""
    tree = params["params"] if "params" in params else params

    def t(x):
        return torch.from_numpy(np.array(x))

    if "layers" in tree:
        stacked = tree["layers"]["layer"]

        def take(node, i):
            return {k: take(v, i) for k, v in node.items()} if isinstance(node, dict) else np.asarray(node)[i]

        layers = [take(stacked, i) for i in range(config.num_hidden_layers)]
    else:
        n_tree = sum(k.startswith("layer_") for k in tree)
        if n_tree != config.num_hidden_layers:
            raise ValueError(
                f"params tree has {n_tree} layers, config.num_hidden_layers is "
                f"{config.num_hidden_layers}"
            )
        layers = [tree[f"layer_{i}"] for i in range(config.num_hidden_layers)]
    sd = {"embed_tokens.weight": t(tree["embed_tokens"]["embedding"])}
    for i, lp in enumerate(layers):
        pre = f"layers.{i}."
        sd[pre + "input_norm.weight"] = t(lp["input_norm"]["scale"])
        sd[pre + "post_attn_norm.weight"] = t(lp["post_attn_norm"]["scale"])
        for name in ("wq", "wk", "wv", "wo"):
            sd[pre + f"attention.{name}.weight"] = t(lp["attention"][name]["kernel"]).T.contiguous()
        for name in ("w_gate", "w_up", "w_down"):
            sd[pre + f"mlp.{name}.weight"] = t(lp["mlp"][name]["kernel"]).T.contiguous()
    sd["final_norm.weight"] = t(tree["final_norm"]["scale"])
    if config.tie_word_embeddings:
        if "lm_head" in tree:
            raise ValueError(
                "tie_word_embeddings=True but the params tree carries a distinct lm_head; "
                "refusing to drop it"
            )
    else:
        if "lm_head" not in tree:
            raise ValueError("tie_word_embeddings=False but the params tree has no lm_head")
        sd["lm_head.weight"] = t(tree["lm_head"]["kernel"]).T.contiguous()
    return sd


class LlamaLayeredApply(DecoderLayeredApply):
    """Llama streamed a layer at a time (JAX's `LlamaLayeredApply`); a tied
    head's tail reads the prelude's embedding."""

    model_cls = LlamaForCausalLM
    PRELUDE = ("embed_tokens",)
    TAIL = ("final_norm", "lm_head")

    def tail_modules(self) -> tuple:
        return self.TAIL + (("embed_tokens",) if self.config.tie_word_embeddings else ())


def llama3_8b() -> LlamaConfig:
    return LlamaConfig()


def llama_1b() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=128256,
        hidden_size=2048,
        intermediate_size=8192,
        num_hidden_layers=16,
        num_attention_heads=32,
        num_key_value_heads=8,
    )


def llama_tiny() -> LlamaConfig:
    """Test-size config."""
    return LlamaConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=256,
        rope_theta=10000.0,
    )
