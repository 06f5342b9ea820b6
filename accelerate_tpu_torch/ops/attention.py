"""Attention ops: the seam the port's Llama calls.

Port of the parts of `accelerate_tpu/ops/attention.py` that serving runs:

  - `dot_product_attention`: the plain einsum-softmax branch (GQA repeat,
    softmax in f32), used by the full causal forward and by prefill. The JAX
    package sends every masked input, and so all of serving's prefill, down
    this branch; its flash kernels are not on the serving path.
  - `write_slot_pool`: the paged cache's write half.
  - `slot_cache_attention`: write this dispatch's K/V into the pool, then
    attend, through either the ``"gather"`` path (gather the pages into a
    logical buffer, mask, softmax: the JAX package's ``"xla"`` oracle) or the
    ``"paged_kernel"`` path (the Hopper kernels of `ops/paged_attention.py`,
    JAX's ``"pallas_paged"``).

Shapes follow [batch, seq, heads, head_dim] throughout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .paged_attention import paged_decode_attention, paged_verify_attention

#: The serving attention implementations `slot_cache_attention` accepts.
SLOT_ATTENTION_IMPLS = ("gather", "paged_kernel")


def make_causal_mask(q_len: int, kv_len: int, device=None) -> torch.Tensor:
    """[q_len, kv_len] bool, aligned bottom-right: query i sees keys
    ``j <= i + (kv_len - q_len)``."""
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(kv_len, device=device)[None, :]
    return j <= i + (kv_len - q_len)


def dot_product_attention(q, k, v, mask=None, *, causal: bool = False, scale: Optional[float] = None):
    """Multi-head (optionally grouped-query) scaled dot-product attention.

    Args:
        q: [B, Sq, Hq, D]
        k / v: [B, Skv, Hkv, D] with Hq % Hkv == 0
        mask: optional bool, [B, 1|Hq, Sq, Skv] or [B, Skv]; True = attend.
        causal: apply a bottom-right causal mask.
        scale: defaults to 1/sqrt(D).
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA requires query heads ({hq}) divisible by kv heads ({hkv})")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
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


def write_slot_pool(k_pool, v_pool, k, v, positions, page_table):
    """The paged cache's write half: scatter this dispatch's [B, s] K/V into
    the pools through the slot page tables, row i's token j landing at
    ``pool[table[i, pos // ps], pos % ps]`` after clipping ``pos`` to
    ``[0, L - 1]`` (L = pages_per_slot * page_size).

    Writes IN PLACE (the JAX package returns new pools; here the pools are the
    engine's long-lived buffers and a copy per dispatch would double the cache
    traffic). Returns the clipped int32 positions."""
    page_size = k_pool.shape[1]
    pages_per_slot = page_table.shape[-1]
    pos = positions.clamp(0, pages_per_slot * page_size - 1)
    page_slot = torch.div(pos, page_size, rounding_mode="floor").long()
    pid = torch.gather(page_table.long(), 1, page_slot)  # [B, s]
    off = (pos % page_size).long()
    k_pool[pid, off] = k.to(k_pool.dtype)
    v_pool[pid, off] = v.to(v_pool.dtype)
    return pos.to(torch.int32)


def slot_cache_attention(q, k, v, k_pool, v_pool, positions, page_table, attention_impl: str = "paged_kernel"):
    """Write this dispatch's K/V into the page pools, then attend.

    Decode steps (s == 1) and speculative verify blocks (s == draft_tokens + 1)
    share this seam; the paged-kernel path picks `paged_decode_attention` or
    `paged_verify_attention` by ``q.shape[1]``. Prefill uses the gather path
    with the prompt as queries (one slot, its own page row).

    Args:
        q: [B, s, Hq, D]; k / v: [B, s, Hkv, D].
        k_pool / v_pool: [num_pages, page_size, Hkv, D], updated in place.
        positions: [B, s] absolute positions; query j of row i attends
            ``cols <= positions[i, j]``.
        page_table: [B, pages_per_slot] int32.
    Returns the attention output [B, s, Hq, D].
    """
    if attention_impl not in SLOT_ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attention_impl {attention_impl!r}; expected one of {SLOT_ATTENTION_IMPLS}"
        )
    b, s = q.shape[:2]
    if positions.shape != (b, s):
        raise ValueError(f"positions must be [B, s] = {(b, s)}, got {tuple(positions.shape)}")
    pos = write_slot_pool(k_pool, v_pool, k, v, positions, page_table)
    if attention_impl == "paged_kernel":
        fn = paged_decode_attention if s == 1 else paged_verify_attention
        return fn(q, k_pool, v_pool, page_table, pos)
    hkv, d = k_pool.shape[2], k_pool.shape[3]
    length = page_table.shape[-1] * k_pool.shape[1]
    table = page_table.long()
    k_full = k_pool[table].reshape(b, length, hkv, d)
    v_full = v_pool[table].reshape(b, length, hkv, d)
    cols = torch.arange(length, device=q.device)
    mask = (cols[None, None, :] <= pos[:, :, None])[:, None]  # [B, 1, s, L]
    return dot_product_attention(q, k_full, v_full, mask=mask)
