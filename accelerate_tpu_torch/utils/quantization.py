"""Weight quantization: int8, int4 and nf4 (the port of
`accelerate_tpu/utils/quantization.py`).

A quantized weight is a `QuantTensor`: its codes (`q`), its scales and the
logical shape. int8 is symmetric per output channel (the scale
``absmax / 127`` over every dim but the last); int4 symmetric per block of
`block_size` elements (``absmax / 7``, codes offset by 8); nf4 QLoRA's
NormalFloat-4 codebook per block (the block's absmax stored). Two 4-bit
codes share a byte, the even element in the low nibble.

Weights are quantized in JAX's layout, the flax view of each parameter
(`parallel.sharding`: a linear weight as its [in, out] kernel), so the
blocks, codes and scales are JAX's bit for bit and a quantized tree is
keyed by flax path. `load_and_quantize_model` wraps a model so that each
forward dequantizes to the compute dtype, turns each weight back to the
module's layout and runs the module on it. All of it is plain torch: JAX
has no kernel here, XLA fuses the dequantize into the matmul, and a
hand-written fused kernel is not part of the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

# QLoRA's NF4 codebook: 16 quantiles of a standard normal, normalized to [-1, 1].
NF4_CODE = torch.tensor(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
        0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
    ],
    dtype=torch.float32,
)

class QuantTensor:
    """A quantized weight: `q` and `scale` tensors and the logical shape,
    the dequantized tensor's."""

    def __init__(self, kind: str, q: torch.Tensor, scale: torch.Tensor, shape: Tuple[int, ...], pad: int = 0,
                 block_size: int = 0):
        self.kind = kind
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)
        self.pad = pad
        self.block_size = block_size

    @property
    def nbytes_quantized(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.q, self.scale))

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return dequantize_entry(self, dtype)

    def __repr__(self):
        return f"QuantTensor({self.kind}, shape={self.shape}, stored={self.nbytes_quantized}B)"


@dataclass
class QuantizationConfig:
    """JAX's `QuantizationConfig`: 8-bit or 4-bit (`quant_type` nf4 or
    int4, per block of `block_size`), the dtype weights dequantize to (bf16
    by default), path substrings kept dense, and the least rank quantized."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    quant_type: str = "nf4"
    block_size: int = 64
    compute_dtype: Any = None
    skip_modules: List[str] = field(default_factory=list)
    min_dims: int = 2

    def __post_init__(self):
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("Pick one of load_in_8bit / load_in_4bit")
        if self.load_in_4bit and self.quant_type not in ("nf4", "int4"):
            raise ValueError(f"Unknown 4-bit quant_type {self.quant_type!r}")

    @property
    def enabled(self) -> bool:
        return self.load_in_8bit or self.load_in_4bit


def _div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` rounded as one IEEE division on every device. CUDA
    divides by a Python number as a product with its reciprocal, which can
    miss by an ulp; a divisor on the device takes the true division, as the
    CPU and JAX do, so the card's codes equal JAX's."""
    return x / torch.tensor(divisor, dtype=x.dtype, device=x.device)


def quantize_int8(w: torch.Tensor) -> QuantTensor:
    """Per-output-channel (last dim) symmetric int8."""
    w32 = w.float()
    # Over every dim but the last; a vector's is itself (torch's amax over
    # no dims would take the whole tensor).
    absmax = w32.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True) if w.dim() > 1 else w32.abs()
    scale = _div(absmax, 127.0)
    q = torch.clamp(torch.round(w32 / scale.clamp_min(1e-12)), -127, 127).to(torch.int8)
    return QuantTensor("int8", q, scale, tuple(w.shape))


def _block_view(w: torch.Tensor, block_size: int):
    flat = w.float().reshape(-1)
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block_size), pad


def _pack(codes: torch.Tensor) -> torch.Tensor:
    codes = codes.to(torch.uint8)
    return codes[:, ::2] | (codes[:, 1::2] << 4)


def quantize_int4(w: torch.Tensor, block_size: int = 64) -> QuantTensor:
    """Per-block symmetric int4: codes round(w / (absmax / 7)) + 8 in
    [1, 15]."""
    blocks, pad = _block_view(w, block_size)
    scale = _div(blocks.abs().amax(dim=1, keepdim=True), 7.0)
    q = torch.clamp(torch.round(blocks / scale.clamp_min(1e-12)), -7, 7).to(torch.int8) + 8
    return QuantTensor("int4", _pack(q), scale, tuple(w.shape), pad, block_size)


def quantize_nf4(w: torch.Tensor, block_size: int = 64) -> QuantTensor:
    """Per-block NormalFloat-4: each element's nearest codebook entry (the
    lower on a tie) after the block is divided by its absmax.

    JAX takes the argmin of the distance to all 16 entries. The codebook is
    sorted, so the nearest entry is one of the two that bracket the value
    (`searchsorted`): the distances to those two, computed as JAX computes
    them, pick the same entry, without a 16-wide temporary."""
    blocks, pad = _block_view(w, block_size)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    normed = blocks / absmax.clamp_min(1e-12)
    code = NF4_CODE.to(w.device)
    above = torch.searchsorted(code, normed)
    lo, hi = (above - 1).clamp(0, 15), above.clamp(max=15)
    idx = torch.where((normed - code[hi]).abs() < (normed - code[lo]).abs(), hi, lo)
    return QuantTensor("nf4", _pack(idx), absmax, tuple(w.shape), pad, block_size)


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    lo = (packed & 0x0F).long()
    hi = (packed >> 4).long()
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)


def dequantize_entry(entry: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The weight a `QuantTensor` stands for, in `dtype` (computed in f32)."""
    if entry.kind == "int8":
        return (entry.q.float() * entry.scale).to(dtype)
    vals = _unpack_nibbles(entry.q)
    if entry.kind == "nf4":
        blocks = NF4_CODE.to(vals.device)[vals] * entry.scale
    elif entry.kind == "int4":
        blocks = (vals - 8).float() * entry.scale
    else:
        raise ValueError(f"Unknown quant kind {entry.kind!r}")
    flat = blocks.reshape(-1)
    if entry.pad:
        flat = flat[: flat.numel() - entry.pad]
    return flat.reshape(entry.shape).to(dtype)


def is_quant_entry(x) -> bool:
    return isinstance(x, QuantTensor)


def _flax_params(params):
    """(flax path, tensor in flax layout) of each parameter of a module, one
    at a time, or of a mapping as given."""
    if not isinstance(params, nn.Module):
        yield from params.items()
        return
    from .modeling import flax_leaves

    for path, _, param, dims in flax_leaves(params):
        yield path, param.detach().permute(dims).contiguous() if dims != tuple(range(param.dim())) else param.detach()


def quantize_params(params, config: QuantizationConfig) -> Dict[str, Any]:
    """{flax path: QuantTensor, or the tensor kept dense} of a module's
    parameters (or of a mapping of flax paths): floating tensors of at
    least `min_dims` dims whose ``/``-led path holds no `skip_modules`
    entry are quantized, as JAX's rules pick them."""
    out = {}
    for path, leaf in _flax_params(params):
        if (leaf.dim() < config.min_dims or not leaf.dtype.is_floating_point
                or any(skip in "/" + path for skip in config.skip_modules)):
            out[path] = leaf
        elif config.load_in_8bit:
            out[path] = quantize_int8(leaf)
        elif config.quant_type == "nf4":
            out[path] = quantize_nf4(leaf, config.block_size)
        else:
            out[path] = quantize_int4(leaf, config.block_size)
    return out


def dequantize_params(qparams: Dict[str, Any], dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every QuantTensor of `quantize_params`'s mapping dequantized to
    `dtype`; dense entries as they are."""
    return {k: dequantize_entry(v, dtype) if is_quant_entry(v) else v for k, v in qparams.items()}


def quantized_nbytes(qparams: Dict[str, Any]) -> int:
    """Bytes of the quantized mapping: codes and scales, and the dense
    tensors."""
    return sum(v.nbytes_quantized if is_quant_entry(v) else v.numel() * v.element_size()
               for v in qparams.values())


class QuantizedModel(nn.Module):
    """A model whose quantized weights live as `QuantTensor`s (`qparams`,
    by flax path); each forward dequantizes them to `compute_dtype`, lays
    each out as the module holds it and runs the module on them. The
    module keeps its dense parameters; a quantized one is a meta tensor."""

    def __init__(self, module: nn.Module, qparams: Dict[str, Any], config: QuantizationConfig):
        super().__init__()
        from .modeling import flax_leaves

        self.module = module
        self.qparams = qparams
        self.quantization_config = config
        self.compute_dtype = config.compute_dtype or torch.bfloat16
        self.loss_fn = getattr(module, "loss_fn", None)
        self._layout = {}  # flax path -> [(torch name, torch dims)]
        for path, name, param, dims in flax_leaves(module):
            if is_quant_entry(qparams.get(path)):
                self._layout.setdefault(path, []).append((name, dims))
                owner, _, pname = name.rpartition(".")
                setattr(module.get_submodule(owner) if owner else module, pname,
                        nn.Parameter(torch.empty(param.shape, dtype=param.dtype, device="meta"),
                                     requires_grad=False))

    def dequantized(self) -> Dict[str, torch.Tensor]:
        """{torch name: the dequantized weight in the module's layout}."""
        out = {}
        for path, names in self._layout.items():
            w = dequantize_entry(self.qparams[path], self.compute_dtype)
            for name, dims in names:
                inverse = [dims.index(i) for i in range(len(dims))]
                out[name] = w.permute(inverse) if dims != tuple(range(len(dims))) else w
        return out

    def forward(self, *args, **kwargs):
        return torch.func.functional_call(self.module, self.dequantized(), args, kwargs, strict=False)

    # ------------------------------------------------------------ generation
    # What `generation.Generator` reads of a causal LM, so that a quantized
    # model generates as JAX's `Generator(qmodel)` does: every step's
    # forward dequantizes the weights.
    @property
    def config(self):
        return self.module.config

    def get_input_embeddings(self) -> nn.Module:
        """The input embedding as the forward sees it: dequantized to
        `compute_dtype` where its weight is quantized."""
        embedding = self.module.get_input_embeddings()
        if embedding.weight.device.type != "meta":
            return embedding
        name = next(n for n, m in self.module.named_modules() if m is embedding)
        return nn.Embedding.from_pretrained(self.dequantized()[f"{name}.weight"])

    def make_decode_cache(self, batch: int, max_length: int, dtype: Optional[torch.dtype] = None, device=None):
        weight = self.get_input_embeddings().weight
        return self.module.make_decode_cache(batch, max_length, dtype=dtype or weight.dtype,
                                             device=device or weight.device)


def load_and_quantize_model(model, config: QuantizationConfig):
    """Quantize a model's eligible weights and wrap it (JAX's
    `load_and_quantize_model`, the reference's bitsandbytes loading): the
    returned `QuantizedModel` holds the codes and scales where the
    weights were, and dequantizes at each forward."""
    module = getattr(model, "module", model)
    if not config.enabled:
        return model
    with torch.no_grad():
        qparams = quantize_params(module, config)
        return QuantizedModel(module, qparams, config)
