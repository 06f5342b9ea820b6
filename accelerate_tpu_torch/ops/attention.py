"""Attention ops: the seam the port's Llama calls.

Port of the parts of `accelerate_tpu/ops/attention.py` that serving and
training run:

  - `dot_product_attention`: the plain einsum-softmax branch (GQA repeat,
    softmax in f32) and, behind JAX's gate (`use_flash`), the flash kernels
    of `ops/flash_attention.py`: long unmasked training sequences on the
    card. Every masked input, and so all of serving's prefill, takes the
    plain branch, as in the JAX package.
  - `write_slot_pool`: the paged cache's write half, into float pools or,
    with scale pools, into int8/fp8 pools (`ops/quantization.py`).
  - `slot_cache_attention`: write this dispatch's K/V into the pool, then
    attend, through either the ``"gather"`` path (gather the pages into a
    logical buffer, dequantized on read for a quantized pool, mask, softmax:
    the JAX package's ``"xla"`` oracle) or the ``"paged_kernel"`` path (the
    Hopper kernels of `ops/paged_attention.py`, JAX's ``"pallas_paged"``).
  - `dense_cache_attention`: the cached prefill's attention over a dense
    per-slot K/V view (`utils/operations.gather_pages`), which holds the
    prompt's own K/V at full precision whatever the pool stores.

Shapes follow [batch, seq, heads, head_dim] throughout.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from .flash_attention import flash_attention
from .paged_attention import paged_decode_attention, paged_verify_attention
from .quantization import dequantize_kv_pages, kv_spec_for_dtype, quantized_pool_write

#: The serving attention implementations `slot_cache_attention` accepts.
SLOT_ATTENTION_IMPLS = ("gather", "paged_kernel")

#: The path the last `dot_product_attention` call took: "flash" or "xla".
LAST_DISPATCH: Optional[str] = None


def make_causal_mask(q_len: int, kv_len: int, device=None) -> torch.Tensor:
    """[q_len, kv_len] bool, aligned bottom-right: query i sees keys
    ``j <= i + (kv_len - q_len)``."""
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(kv_len, device=device)[None, :]
    return j <= i + (kv_len - q_len)


def use_flash(implementation: Optional[str], masked: bool, sq: int, skv: int, causal: bool,
              on_cuda: bool) -> bool:
    """The flash gate of JAX's `dot_product_attention`: an explicit
    ``"flash"``, or, with no implementation named, an unmasked call with
    ``Sq >= 1024`` and both lengths multiples of 128 on the card (JAX: on a
    TPU), unless it is causal with ``Sq > Skv``, a mask the kernels reject."""
    if implementation == "flash":
        return True
    if implementation is not None or masked or not on_cuda:
        return False
    if sq < 1024 or sq % 128 or skv % 128:
        return False
    return not (causal and sq > skv)


def dot_product_attention(
    q,
    k,
    v,
    mask=None,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    implementation: Optional[str] = None,
):
    """Multi-head (optionally grouped-query) scaled dot-product attention.

    Args:
        q: [B, Sq, Hq, D]
        k / v: [B, Skv, Hkv, D] with Hq % Hkv == 0
        mask: optional bool, [B, 1|Hq, Sq, Skv] or [B, Skv]; True = attend.
        causal: apply a bottom-right causal mask.
        scale: defaults to 1/sqrt(D).
        implementation: ``"xla"`` (the plain einsum-softmax path, JAX's name
            for it), ``"flash"`` (the kernels of `ops/flash_attention.py`,
            which take no mask), or None: `use_flash` decides. With None,
            ``ACCELERATE_TPU_ATTENTION_IMPL=xla|flash`` forces one for every
            call, as in the JAX package. `LAST_DISPATCH` records the choice.
    """
    global LAST_DISPATCH
    if implementation is None:
        forced = os.environ.get("ACCELERATE_TPU_ATTENTION_IMPL")
        if forced in ("xla", "flash"):
            implementation = forced
    if implementation not in (None, "xla", "flash"):
        raise ValueError(f"unknown implementation {implementation!r}; expected 'xla' or 'flash'")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA requires query heads ({hq}) divisible by kv heads ({hkv})")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if implementation == "flash" and mask is not None:
        raise ValueError(
            "implementation='flash' cannot honor a mask argument: the kernels thread only "
            "`causal`. Drop implementation= to let the dispatcher pick the plain path, or "
            "pass implementation='xla'."
        )
    if use_flash(implementation, mask is not None, sq, skv, causal, q.is_cuda):
        LAST_DISPATCH = "flash"
        return flash_attention(q, k, v, causal=causal, scale=scale)
    LAST_DISPATCH = "xla"
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)  # [B, H, S, D]
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale  # [B, H, Sq, Skv]
    neg = torch.finfo(scores.dtype).min
    if causal:
        scores = scores.masked_fill(~make_causal_mask(sq, skv, q.device), neg)
    if mask is not None:
        if mask.ndim == 2:  # [B, Skv] padding mask
            mask = mask[:, None, None, :]
        scores = scores.masked_fill(~mask.bool(), neg)
    # Softmax in fp32 for stability under bf16 compute.
    s32 = scores.float()
    probs = torch.exp(s32 - s32.amax(dim=-1, keepdim=True))
    probs = (probs / probs.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)


def write_slot_pool(k_pool, v_pool, k, v, positions, page_table, k_scale=None, v_scale=None):
    """The paged cache's write half: scatter this dispatch's [B, s] K/V into
    the pools through the slot page tables, row i's token j landing at
    ``pool[table[i, pos // ps], pos % ps]`` after clipping ``pos`` to
    ``[0, L - 1]`` (L = pages_per_slot * page_size). With scale pools
    (``[num_pages, Hkv]`` f32) the pools are int8 or fp8 and the write is
    `quantized_pool_write`'s, which keeps each touched page's scale.

    Writes IN PLACE, scales included (the JAX package returns new pools; here
    the pools are the engine's long-lived buffers and a copy per dispatch
    would double the cache traffic). Returns the clipped int32 positions."""
    page_size = k_pool.shape[1]
    pages_per_slot = page_table.shape[-1]
    pos = positions.clamp(0, pages_per_slot * page_size - 1)
    page_slot = torch.div(pos, page_size, rounding_mode="floor").long()
    pid = torch.gather(page_table.long(), 1, page_slot)  # [B, s]
    off = (pos % page_size).long()
    if k_scale is None:
        k_pool[pid, off] = k.to(k_pool.dtype)
        v_pool[pid, off] = v.to(v_pool.dtype)
    else:
        quantized_pool_write(k_pool, k_scale, k, pid, off, kv_spec_for_dtype(k_pool.dtype))
        quantized_pool_write(v_pool, v_scale, v, pid, off, kv_spec_for_dtype(v_pool.dtype))
    return pos.to(torch.int32)


def _attend_logical(q, k_full, v_full, pos):
    """Attention of [B, s] queries over a logical [B, L, Hkv, D] cache, query
    j of row i seeing ``cols <= pos[i, j]``."""
    length = k_full.shape[1]
    cols = torch.arange(length, device=q.device)
    mask = (cols[None, None, :] <= pos[:, :, None])[:, None]  # [B, 1, s, L]
    return dot_product_attention(q, k_full, v_full, mask=mask)


def slot_cache_attention(q, k, v, k_pool, v_pool, positions, page_table, attention_impl: str = "paged_kernel",
                         k_scale=None, v_scale=None):
    """Write this dispatch's K/V into the page pools, then attend.

    Decode steps (s == 1) and speculative verify blocks (s == draft_tokens + 1)
    share this seam; the paged-kernel path picks `paged_decode_attention` or
    `paged_verify_attention` by ``q.shape[1]``.

    Args:
        q: [B, s, Hq, D]; k / v: [B, s, Hkv, D].
        k_pool / v_pool: [num_pages, page_size, Hkv, D], updated in place.
        positions: [B, s] absolute positions; query j of row i attends
            ``cols <= positions[i, j]``.
        page_table: [B, pages_per_slot] int32.
        k_scale / v_scale: [num_pages, Hkv] f32 scales of int8/fp8 pools,
            updated in place; the kernels take them and dequantize in the
            page walk, the gather path dequantizes the gathered pages to k's
            dtype.
    Returns the attention output [B, s, Hq, D].
    """
    if attention_impl not in SLOT_ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attention_impl {attention_impl!r}; expected one of {SLOT_ATTENTION_IMPLS}"
        )
    b, s = q.shape[:2]
    if positions.shape != (b, s):
        raise ValueError(f"positions must be [B, s] = {(b, s)}, got {tuple(positions.shape)}")
    pos = write_slot_pool(k_pool, v_pool, k, v, positions, page_table, k_scale, v_scale)
    if attention_impl == "paged_kernel":
        fn = paged_decode_attention if s == 1 else paged_verify_attention
        return fn(q, k_pool, v_pool, page_table, pos, k_scale=k_scale, v_scale=v_scale)
    hkv, d = k_pool.shape[2], k_pool.shape[3]
    length = page_table.shape[-1] * k_pool.shape[1]
    table = page_table.long()
    k_pages, v_pages = k_pool[table], v_pool[table]  # [B, P, ps, Hkv, D]
    if k_scale is not None:
        k_pages = dequantize_kv_pages(k_pages, k_scale[table], k.dtype)
        v_pages = dequantize_kv_pages(v_pages, v_scale[table], v.dtype)
    return _attend_logical(q, k_pages.reshape(b, length, hkv, d), v_pages.reshape(b, length, hkv, d), pos)


def dense_cache_attention(q, k, v, k_cache, v_cache, positions):
    """The cached prefill's attention (JAX's dense decode cache,
    `update_decode_cache`): write this block's K/V into the dense per-slot
    caches ``[B, L, Hkv, D]`` at `positions` ([B, s], IN PLACE), then attend
    ``cols <= positions[i, j]``. The caches hold the matched prefix (read
    from the pool, dequantized) and the block's own K/V at full precision."""
    pos = positions.clamp(0, k_cache.shape[1] - 1).long()
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)[:, None]
    k_cache[rows, pos] = k.to(k_cache.dtype)
    v_cache[rows, pos] = v.to(v_cache.dtype)
    return _attend_logical(q, k_cache, v_cache, pos)
