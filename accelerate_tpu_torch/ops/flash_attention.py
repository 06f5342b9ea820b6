"""Flash attention for training: FlashAttention-2 forward and backward.

Port of `accelerate_tpu/ops/flash_attention.py`. On CUDA tensors each entry
launches the hand-written Hopper kernels of `csrc/flash_attention.cu`:
K3 (forward: o and the row logsumexp), K4 (dK, dV) and K5 (dQ); in bf16
and fp16, all three run on the tensor cores (wgmma over TMA-loaded tiles,
with the shared building blocks in `csrc/flash_tiles.cuh`; in fp16 P and dS
are scaled by powers of two before they are narrowed, so that dS does not
overflow under loss scaling), in f32 on the CUDA cores; all at head dims
16 (T5-tiny), 32, 64, 96 (GPT-NeoX-20B), 128 (Mixtral-8x7B) and 256
(GPT-J-6B). On CPU tensors it runs
the plain PyTorch versions below, which work
on the full [S, Sk] score matrix in fp32; the tests and `chip_smoke.py`
hold the kernels against them. Nothing falls back: a CUDA tensor the
kernels do not take raises, and so does a kernel that fails to build or
launch (a tensor map that does not encode, say).

Contract (the JAX package's): scores ``s = (q . k) * scale`` summed in fp32;
``causal`` masks are aligned bottom-right, query i seeing keys
``j <= i + (Sk - S)``, which needs ``S <= Sk``; outputs come back in q's
dtype, ``lse`` in fp32 as one value per row, ``[B*H, S]`` (the TPU kernel's
128-lane broadcast was a Mosaic tiling artefact). The backward recomputes
``p = exp(s - lse)`` from the saved lse and takes
``delta = rowsum(do * o)`` computed outside the kernels, as JAX does.

Entries:
  - `flash_fwd` (K3), `flash_bwd_dkv` (K4), `flash_bwd_dq` (K5) and
    `flash_bwd` (delta, K4, K5): block level, ``[B*H, S, D]`` in and out,
    the seam ring attention calls once per K/V block;
  - `FlashAttentionFunction`: the autograd function over them;
  - `flash_attention`: the public ``[B, S, H, D]`` op, with grouped-query
    K/V heads repeated before the kernels, as JAX does.

`LAUNCHES` counts kernel launches, one per launch of each kernel: under
``flash_fwd``, ``flash_bwd_dkv`` and ``flash_bwd_dq`` those on f32 and bf16
tensors, under the same names with ``_f16`` those on fp16 tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from .flash_common import NEG_INF

#: Kernel launches since the last reset, by kernel.
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
    "flash_fwd_f16": 0, "flash_bwd_dkv_f16": 0, "flash_bwd_dq_f16": 0,
}

#: Head dimensions the kernels are built for.
HEAD_DIMS = (16, 32, 64, 96, 128, 256)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launch_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib():
    from ._build import load

    lib = load("flash_attention")
    if lib.flash_fwd_launch.argtypes is None:
        shape = [_I] * 4 + [_F, _I, _I, _P]  # BH, S, Sk, D, scale, causal, dtype, stream
        lib.flash_fwd_launch.argtypes = [_P] * 5 + shape
        lib.flash_bwd_dkv_launch.argtypes = [_P] * 8 + shape
        lib.flash_bwd_dq_launch.argtypes = [_P] * 7 + shape
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dkv_launch, lib.flash_bwd_dq_launch):
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


# ------------------------------------------------------------- plain versions
# The plain versions compute in fp32, or in float64 for float64 inputs: the
# card's checks hold the f32 kernels to them on the same inputs widened to
# float64, where the f32 plain version's own rounding would take most of the
# f32 limit (`chip_smoke.flash_kernel_phase`).
def _wide(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _scores(q, k, causal, scale):
    """fp32 (float64 for float64 inputs) [BH, S, Sk] scaled scores, masked
    bottom-right with NEG_INF."""
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * scale
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(cols > rows + (skv - sq), NEG_INF)
    return s


def flash_fwd_reference(q, k, v, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K3: (o in q's dtype, lse [BH, S] fp32, or
    float64 for float64 inputs)."""
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, _wide(v)) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The plain version of K4: (dk, dv) in q's dtype."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    do32 = _wide(do)
    dv = torch.matmul(p.transpose(-1, -2), do32)
    ds = p * (torch.matmul(do32, _wide(v).transpose(-1, -2)) - delta[..., None]) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _wide(q))
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The plain version of K5: dq in q's dtype."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    ds = p * (torch.matmul(_wide(do), _wide(v).transpose(-1, -2)) - delta[..., None]) * scale
    return torch.matmul(ds, _wide(k)).to(q.dtype)


def _delta(o, do):
    """rowsum(do * o) in fp32, [BH, S]: computed outside the kernels, as JAX does."""
    return (_wide(do) * _wide(o)).sum(dim=-1)


def flash_bwd_reference(q, k, v, o, lse, do, causal: bool, scale: float):
    """The plain version of K4 + K5: (dq, dk, dv) in q's dtype."""
    delta = _delta(o, do)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale), dk, dv


# ------------------------------------------------------------------ kernels
def _check_blocks(q, k, v, causal):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"expected q [BH, S, D] and k, v [BH, Sk, D], got {q.shape}, {k.shape}, {v.shape}")
    if q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in BH or D")
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(f"causal flash attention requires Sq <= Skv, got ({q.shape[1]}, {k.shape[1]})")


def _check_cuda(**tensors):
    q = tensors["q"]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernels take float32, bfloat16 or float16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the kernels are built for head_dim in {HEAD_DIMS}, got {q.shape[-1]}")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")


def _run(kind, *args):
    """Launch `kind` on PyTorch's current stream of q's device; tensors go
    by pointer. Raises on a non-zero cudaError."""
    lib = _lib()
    q = args[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"{kind}_launch")(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream
        )
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: {lib.flash_attention_error_string(err).decode()}")
    LAUNCHES[kind + ("_f16" if q.dtype == torch.float16 else "")] += 1


def _shape_args(q, k, scale, causal):
    bh, s, d = q.shape
    return [bh, s, k.shape[1], d, float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype]]


def _launch_fwd(q, k, v, causal, scale):
    _check_cuda(q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _run("flash_fwd", q, k, v, o, lse, *_shape_args(q, k, scale, causal))
    return o, lse


def _check_bwd(q, k, v, do, lse, delta):
    if do.shape != q.shape or lse.shape != q.shape[:2] or delta.shape != q.shape[:2]:
        raise ValueError(
            f"expected do {tuple(q.shape)} and lse, delta {tuple(q.shape[:2])}, got "
            f"{tuple(do.shape)}, {tuple(lse.shape)}, {tuple(delta.shape)}"
        )
    _check_cuda(q=q, k=k, v=v, do=do, lse=lse, delta=delta)


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    _check_bwd(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _run("flash_bwd_dkv", q, k, v, do, lse, delta, dk, dv, *_shape_args(q, k, scale, causal))
    return dk, dv


def _launch_bwd_dq(q, k, v, do, lse, delta, causal, scale):
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _run("flash_bwd_dq", q, k, v, do, lse, delta, dq, *_shape_args(q, k, scale, causal))
    return dq


def _on_device(launch, reference, q, k, v, *rest, causal, scale):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_blocks(q, k, v, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return launch(q, k, v, *rest, causal, scale)
    if q.device.type == "cpu":
        return reference(q, k, v, *rest, causal, scale)
    raise ValueError(f"no flash attention for tensors on {q.device}")


def flash_fwd(q, k, v, *, causal: bool = False, scale: Optional[float] = None):
    """K3, block level, on [BH, S, D] q and [BH, Sk, D] k, v: returns
    (o [BH, S, D] in q's dtype, lse [BH, S] fp32)."""
    return _on_device(_launch_fwd, flash_fwd_reference, q, k, v, causal=causal, scale=scale)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = False, scale: Optional[float] = None):
    """K4, block level: (dk, dv) in q's dtype from the output cotangent do,
    the forward's lse and delta = rowsum(do * o)."""
    return _on_device(_launch_bwd_dkv, flash_bwd_dkv_reference, q, k, v, do, lse, delta,
                      causal=causal, scale=scale)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = False, scale: Optional[float] = None):
    """K5, block level: dq in q's dtype, from the same inputs as K4."""
    return _on_device(_launch_bwd_dq, flash_bwd_dq_reference, q, k, v, do, lse, delta,
                      causal=causal, scale=scale)


def flash_bwd(q, k, v, o, lse, do, *, causal: bool = False, scale: Optional[float] = None):
    """Block-level backward: (dq, dk, dv) in q's dtype from the forward's o
    and lse and the output cotangent do, through K4 and K5."""
    delta = _delta(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale), dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """o = attention(q, k, v) on [BH, S, D], forward through `flash_fwd`,
    backward through `flash_bwd` from the saved (q, k, v, o, lse): the port
    of JAX's custom VJP `_flash_bhsd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
):
    """Flash attention on [B, S, H, D] inputs; grouped-query K/V heads are
    repeated to the query heads first, so autograd sums dK/dV over a group.

    Requires ``Sq % block_q == 0`` and ``Skv % block_k == 0`` with each block
    shrunk to its sequence length (JAX's contract: callers pad or take the
    plain path through `dot_product_attention`), and ``Sq <= Skv`` when
    causal. The kernels tile by their own sizes and need neither; the checks
    keep the two packages' contracts equal."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    block_q = min(block_q, sq)
    block_k = min(block_k, skv)
    if sq % block_q or skv % block_k:
        raise ValueError(f"Sequence lengths ({sq}, {skv}) must divide blocks ({block_q}, {block_k})")
    if causal and sq > skv:
        raise ValueError(f"causal flash attention requires Sq <= Skv, got ({sq}, {skv})")
    if hq != hkv:
        if hq % hkv:
            raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq}, {hkv}")
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    qt = q.transpose(1, 2).reshape(b * hq, sq, d).contiguous()
    kt = k.transpose(1, 2).reshape(b * hq, skv, d).contiguous()
    vt = v.transpose(1, 2).reshape(b * hq, skv, d).contiguous()
    o = FlashAttentionFunction.apply(qt, kt, vt, bool(causal), float(scale))
    return o.reshape(b, hq, sq, d).transpose(1, 2)
