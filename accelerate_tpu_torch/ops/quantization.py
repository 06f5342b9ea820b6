"""Serving quantization: int8 weight-only matmuls and the quantized KV page
pool (int8 or fp8 e4m3 pages with per-page-per-head f32 scales).

Port of `accelerate_tpu/ops/quantization.py`. Decode reads every weight and
every live KV page once per step, so stored bytes per value set its cost:

  - **Weight-only int8** (`weight_dtype="int8"`): `quantize_model_int8`
    turns every `nn.Linear` of a model into an `Int8Linear` holding the int8
    matrix and one symmetric scale per output channel, computed once. Its
    forward is ``(x @ q.T) * scale`` in x's dtype; a per-output-channel scale
    makes the epilogue exact with respect to dequantize-then-matmul.
  - **Quantized KV pool** (`kv_cache_dtype="int8" | "fp8_e4m3"`): the paged
    cache stores pages in the quantized dtype with ``[num_pages, Hkv]`` f32
    scales beside them. `ops/attention.py`'s gather path dequantizes on read;
    the paged kernels (`ops/paged_attention.py`) dequantize inside the page
    walk, reading one byte per cached value.

Page-scale maintenance (`quantized_pool_write`) keeps ``stored * scale ~=
value`` for every live row: a write at page offset 0 resets the page's scale
(a new occupant), every write raises it to cover the incoming token
(scatter-max), and a page whose scale grew is requantized in the same
dispatch. The insert path (`utils/operations.py`) quantizes whole pages at
their own amax.

fp8 note: torch's cast to ``float8_e4m3fn`` gives NaN above 448 where it
should saturate, so every fp8 cast here clips to +-448 first, as the JAX
package's saturating casts do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

#: fp8 e4m3 storage and its largest finite value (`accelerate_tpu/ops/fp8.py`).
E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0

#: KV page-pool storage dtypes. "bf16" means unquantized: pages keep the
#: model's compute dtype (bf16 on the card, f32 in the CPU tests).
KV_CACHE_DTYPES = ("bf16", "int8", "fp8_e4m3")

#: Weight storage dtypes of the serving engine.
WEIGHT_DTYPES = ("bf16", "int8")

#: Scale floor: no division by zero for all-zero pages or channels.
_TINY = 1e-12

INT8_MAX = 127.0

QuantSpec = Tuple[torch.dtype, float]


def kv_quant_spec(kv_cache_dtype: str) -> Optional[QuantSpec]:
    """``(storage dtype, qmax)`` for a quantized KV cache dtype, or None for
    the unquantized "bf16". Raises on anything off `KV_CACHE_DTYPES`."""
    if kv_cache_dtype == "bf16":
        return None
    if kv_cache_dtype == "int8":
        return torch.int8, INT8_MAX
    if kv_cache_dtype == "fp8_e4m3":
        return E4M3, E4M3_MAX
    raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r}; expected one of {KV_CACHE_DTYPES}")


def kv_spec_for_dtype(dtype: torch.dtype) -> Optional[QuantSpec]:
    """``(dtype, qmax)`` for a pool's storage dtype, or None for a float pool."""
    if dtype == torch.int8:
        return torch.int8, INT8_MAX
    if dtype == E4M3:
        return E4M3, E4M3_MAX
    return None


def _cast_quantized(x, dtype, qmax):
    """f32 values already divided by their scale -> storage dtype. int8
    rounds half to even, then clips; fp8 clips to +-qmax, then the cast
    rounds (an unclipped cast above 448 would give NaN)."""
    if dtype == torch.int8:
        return torch.clamp(torch.round(x), -qmax, qmax).to(torch.int8)
    return torch.clamp(x, -qmax, qmax).to(dtype)


def quantize_kv(x, scale, dtype, qmax):
    """Quantize K/V values against a broadcastable `scale` tensor."""
    return _cast_quantized(x.float() / torch.clamp(scale, min=_TINY), dtype, qmax)


def dequantize_kv(q, scale, dtype=torch.float32):
    """``q * scale`` in f32, cast to `dtype`."""
    return (q.float() * scale).to(dtype)


def requantize_kv(q, ratio, dtype, qmax):
    """Stored values re-expressed under a grown scale, ``q * (old / new)``;
    a page whose scale was reset carries ratio 0, which zeroes it."""
    return _cast_quantized(q.float() * ratio, dtype, qmax)


def quantized_pool_write(pool, scale, x, pid, off, spec):
    """Write this dispatch's ``[B, s, h, d]`` K or V rows into the quantized
    page pool at ``(pid, off)`` (``[B, s]`` pool pages and in-page offsets),
    keeping the ``[num_pages, h]`` f32 `scale` of every touched page. Both
    `pool` and `scale` are updated IN PLACE (they are the engine's long-lived
    buffers); JAX's version returns new arrays with the same content.

    In the order JAX's functional writes imply:
      1. a write at offset 0 resets its page's scale to 0 (other writes route
         their reset at scratch page 0, whose rows are never attended);
      2. the scale rises to cover each incoming token (a scatter-max:
         duplicate page ids, the scratch page or the tokens of a verify block
         that share a page, all fold in);
      3. every touched page, read BEFORE this dispatch's token writes, is
         requantized by ratio = (scale after the reset) / (new scale);
      4. the tokens are quantized under the new scale and written."""
    dtype, qmax = spec
    h = scale.shape[1]
    pid, off = pid.long(), off.long()
    amax = x.float().abs().amax(dim=-1)  # [B, s, h]
    reset_pid = torch.where(off == 0, pid, torch.zeros_like(pid))
    after_reset = scale.clone()
    after_reset[reset_pid] = 0.0
    new_scale = after_reset.clone().scatter_reduce_(
        0, pid.reshape(-1, 1).expand(-1, h), (amax / qmax).reshape(-1, h), "amax"
    )
    safe = torch.clamp(new_scale, min=_TINY)
    ratio = after_reset / safe  # [num_pages, h]
    touched = pool[pid]  # [B, s, ps, h, d], a copy taken before the writes
    pool[pid] = requantize_kv(touched, ratio[pid][:, :, None, :, None], dtype, qmax)
    pool[pid, off] = quantize_kv(x, safe[pid][..., None], dtype, qmax)
    scale.copy_(new_scale)


def quantize_kv_pages(blocks, spec):
    """Whole-page quantization for the insert path: float pages ``[P, ...,
    page_size, h, d]`` -> (quantized pages, ``[P, ..., h]`` scales at each
    page's per-head amax)."""
    dtype, qmax = spec
    amax = blocks.float().abs().amax(dim=(-3, -1))  # [P, ..., h]
    scale = amax / qmax
    return quantize_kv(blocks, scale[..., None, :, None], dtype, qmax), scale


def dequantize_kv_pages(blocks, scale, dtype):
    """Inverse of `quantize_kv_pages` for gathered pages: `blocks` ``[...,
    P, page_size, h, d]`` quantized, `scale` ``[..., P, h]``."""
    return dequantize_kv(blocks, scale[..., :, None, :, None], dtype)


# ------------------------------------------------------------------- weights


def quantize_weight_int8(w):
    """Per-output-channel symmetric int8 of an `nn.Linear` weight ``[out,
    in]``: ``w ~= q * scale[:, None]`` with `scale` ``[out]`` f32. (JAX's flax
    kernels are ``[in, out]`` and scale over every axis but the last: the
    same channels.)"""
    w32 = w.detach().float()
    scale = w32.abs().amax(dim=-1) / INT8_MAX
    q = torch.clamp(torch.round(w32 / torch.clamp(scale, min=_TINY)[:, None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_weight_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale[:, None]).to(dtype)


class Int8Linear(nn.Module):
    """A linear layer over an int8 weight: `q` ``[out, in]`` int8 and
    `scale` ``[out]`` f32 buffers, and the layer's bias (or None), kept in
    its own dtype. The int8 matrix is widened to x's dtype for the product,
    the per-output-channel scale is applied to the f32 result, which is
    rounded to x's dtype, and the bias is added after, in that dtype (JAX's
    `_int8_dense_apply`). A W8A16 GEMM that reads the int8 matrix directly
    is later work."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.out_features, self.in_features = q.shape
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, linear: nn.Linear, device=None) -> "Int8Linear":
        """`linear` quantized; with `device`, the arithmetic runs there and
        the int8 weight and scale come back to the layer's device."""
        bias = None if linear.bias is None else linear.bias.detach()
        home = linear.weight.device
        q, scale = quantize_weight_int8(linear.weight if device is None else linear.weight.to(device))
        return cls(q.to(home), scale.to(home), bias)

    def forward(self, x):
        y = (F.linear(x, self.q.to(x.dtype)).float() * self.scale).to(x.dtype)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def quantize_model_int8(model: nn.Module, device=None) -> nn.Module:
    """A copy of `model` whose every `nn.Linear` is an `Int8Linear` (for
    Llama: wq, wk, wv, wo, w_gate, w_up, w_down and an untied lm_head; for
    GPT-NeoX its biased projections and `embed_out`); embeddings, norms and
    the linear layers' biases are the caller's own tensors, shared, not
    copied.
    The caller's model is not changed, and a model with no `nn.Linear` left
    comes back as a copy with the same tensors (idempotent). With `device`
    each layer is quantized there, one at a time, and kept where the model
    lies (a host model's layers on the card: the card's arithmetic, at
    one layer's memory)."""
    import copy

    memo = {}
    for module in model.modules():
        if isinstance(module, nn.Linear):
            memo[id(module.weight)] = None  # dropped from the copy, quantized below
            if module.bias is not None:
                memo[id(module.bias)] = module.bias  # shared, and kept by the Int8Linear
        else:
            for t in [*module.parameters(recurse=False), *module.buffers(recurse=False)]:
                memo[id(t)] = t  # shared
    quantized = {name: Int8Linear.from_linear(m, device) for name, m in model.named_modules()
                 if isinstance(m, nn.Linear)}
    out = copy.deepcopy(model, memo)
    for name, layer in quantized.items():
        parent_name, _, child = name.rpartition(".")
        setattr(out.get_submodule(parent_name) if parent_name else out, child, layer)
    return out


def params_nbytes(model: nn.Module) -> int:
    """Stored bytes of a model's parameters and buffers (each tensor once)."""
    seen = {}
    for t in [*model.parameters(), *model.buffers()]:
        seen[id(t)] = t.numel() * t.element_size()
    return sum(seen.values())
