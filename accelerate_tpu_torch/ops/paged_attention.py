"""Paged-KV attention for serving: single-query decode and the speculative
block-verify, read straight off the page pool.

Port of `accelerate_tpu/ops/paged_attention.py`. On CUDA tensors each public
function launches the hand-written Hopper kernel in `csrc/paged_attention.cu`
(one thread block per (KV head, slot) walking that slot's page table); on CPU
tensors it runs `paged_attention_reference`, the plain PyTorch version of the
same function that the tests and `chip_smoke.py` hold the kernel against.
Nothing falls back: a CUDA tensor the kernel does not take raises, and so does
a kernel that fails to build or launch.

Contract (the JAX package's): query j of slot b attends ``cols <= positions[b, j]``
of its logical cache, whose page p is pool page ``page_table[b, p]`` (clipped
to ``[0, num_pages - 1]``); the pools already hold this dispatch's K/V writes;
query head ``h * G + g`` rides KV head ``h`` (G = Hq // Hkv, contiguous
groups). Rows of inactive slots point at scratch page 0 and come out finite.

`LAUNCHES` counts kernel launches, one per call that reached the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from .flash_common import NEG_INF

#: Kernel launches since the last reset, by kernel.
LAUNCHES: Dict[str, int] = {"decode": 0, "verify": 0}

#: Shared memory a block may use on Hopper (232,448 bytes).
_MAX_SHARED_BYTES = 232448

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launch_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib():
    from ._build import load

    lib = load("paged_attention")
    if lib.paged_decode_launch.argtypes is None:
        lib.paged_decode_launch.argtypes = [_P] * 6 + [_I] * 7 + [_F, _I, _P]
        lib.paged_decode_launch.restype = ctypes.c_int
        lib.paged_verify_launch.argtypes = [_P] * 6 + [_I] * 8 + [_F, _I, _P]
        lib.paged_verify_launch.restype = ctypes.c_int
        lib.paged_attention_shared_bytes.argtypes = [_I] * 5
        lib.paged_attention_shared_bytes.restype = ctypes.c_ulonglong
        lib.paged_attention_error_string.argtypes = [_I]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention_reference(q, k_pool, v_pool, page_table, positions, scale=None):
    """The plain version of both kernels: gather every slot's pages into a
    logical [B, L, Hkv, D] buffer, mask ``cols <= positions[b, j]`` with
    NEG_INF, f32 softmax, output in q's dtype."""
    b, s, hq, d = q.shape
    n, ps, hkv, _ = k_pool.shape
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    table = page_table.long().clamp(0, n - 1)
    length = table.shape[1] * ps
    k = k_pool[table].reshape(b, length, hkv, d).float()
    v = v_pool[table].reshape(b, length, hkv, d).float()
    qg = q.float().reshape(b, s, hkv, g, d)
    scores = torch.einsum("bshgd,blhd->bhsgl", qg, k) * scale
    cols = torch.arange(length, device=q.device)
    visible = cols[None, None, :] <= positions.reshape(b, s, 1).long()  # [B, s, L]
    scores = scores.masked_fill(~visible[:, None, :, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhsgl,blhd->bshgd", probs, v)
    return out.reshape(b, s, hq, d).to(q.dtype)


def _check(q, k_pool, v_pool, page_table, positions):
    if q.ndim != 4 or k_pool.ndim != 4:
        raise ValueError(f"expected q [B, s, Hq, D] and pools [N, ps, Hkv, D], got {q.shape}, {k_pool.shape}")
    b, s, hq, d = q.shape
    n, ps, hkv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d:
        raise ValueError(f"pool shapes {k_pool.shape}/{v_pool.shape} do not fit q {q.shape}")
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq}, {hkv}")
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be [B, pages_per_slot], got {page_table.shape}")
    if positions.numel() != b * s:
        raise ValueError(f"positions must hold [B, s] = {(b, s)} values, got {positions.shape}")


def _launch(kind, q, k_pool, v_pool, page_table, positions, scale):
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, page_table=page_table, positions=positions)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(
            f"the kernel takes float32 or bfloat16 q and pools of q's dtype, got "
            f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
        )
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("page_table and positions must be int32")
    b, s, hq, d = q.shape
    n, ps, hkv, _ = k_pool.shape
    if d % 8:
        raise ValueError(f"the kernel needs head_dim % 8 == 0 for 16-byte loads, got {d}")
    for name in ("q", "k_pool", "v_pool"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _lib()
    smem = lib.paged_attention_shared_bytes(s, hq, hkv, d, ps)
    if smem > _MAX_SHARED_BYTES:
        raise ValueError(f"{smem} bytes of shared memory per block exceed the card's {_MAX_SHARED_BYTES}")
    out = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, k_pool, v_pool, page_table, positions, out)]
    p = page_table.shape[1]
    # The launch goes to the current device on PyTorch's current stream of
    # q's device, behind this dispatch's pool writes.
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kind == "decode":
            err = lib.paged_decode_launch(
                *ptrs, b, hq, hkv, d, n, ps, p, float(scale), _DTYPE_CODES[q.dtype], stream
            )
        else:
            err = lib.paged_verify_launch(
                *ptrs, b, s, hq, hkv, d, n, ps, p, float(scale), _DTYPE_CODES[q.dtype], stream
            )
    if err != 0:
        raise RuntimeError(
            f"paged {kind} kernel launch failed: {lib.paged_attention_error_string(err).decode()}"
        )
    LAUNCHES[kind] += 1
    return out


def _paged_call(kind, q, k_pool, v_pool, page_table, positions, scale):
    _check(q, k_pool, v_pool, page_table, positions)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _launch(kind, q, k_pool, v_pool, page_table, positions, scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table, positions, scale)
    raise ValueError(f"no paged attention for tensors on {q.device}")


def paged_decode_attention(q, k_pool, v_pool, page_table, positions, *, scale: Optional[float] = None):
    """Single-query paged decode attention over a pool-resident KV cache.

    Args:
        q: [B, 1, Hq, D] this step's queries (one per slot).
        k_pool / v_pool: [num_pages, page_size, Hkv, D] page pools, already
            holding this dispatch's K/V writes.
        page_table: [B, pages_per_slot] int32 pool-page ids; unused entries
            point at the scratch page.
        positions: [B, 1] (or [B]) int32; row i attends ``cols <= positions[i]``.
        scale: defaults to 1/sqrt(D).

    Returns [B, 1, Hq, D] in q's dtype.
    """
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention takes [B, 1, Hq, D] queries, got {tuple(q.shape)}")
    return _paged_call("decode", q, k_pool, v_pool, page_table, positions, scale)


def paged_verify_attention(q, k_pool, v_pool, page_table, positions, *, scale: Optional[float] = None):
    """Block-verify paged attention, the [B, s] variant that speculative
    decoding's verify step runs (s = draft_tokens + 1).

    Args:
        q: [B, s, Hq, D] the block's queries.
        k_pool / v_pool / page_table: as `paged_decode_attention`.
        positions: [B, s] int32; query j of row i attends ``cols <= positions[i, j]``.

    Returns [B, s, Hq, D].
    """
    if q.ndim != 4:
        raise ValueError(f"paged_verify_attention takes [B, s, Hq, D] queries, got {tuple(q.shape)}")
    return _paged_call("verify", q, k_pool, v_pool, page_table, positions, scale)
