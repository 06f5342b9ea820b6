"""Attention ops: the seam the port's Llama calls.

Port of the parts of `accelerate_tpu/ops/attention.py` that serving and
training run:

  - `dot_product_attention`: the plain einsum-softmax branch (GQA repeat,
    softmax in f32) and, behind JAX's gate (`use_flash`), the flash kernels
    of `ops/flash_attention.py`: long unmasked training sequences on the
    card. Every masked input, and so all of serving's prefill, takes the
    plain branch, as in the JAX package; so does a packed batch's
    ``segment_ids`` (`segment_mask`, attention within equal ids) and a
    call with an additive score ``bias`` (T5's relative positions).
  - `write_slot_pool`: the paged cache's write half, into float pools or,
    with scale pools, into int8/fp8 pools (`ops/quantization.py`).
  - `slot_cache_attention`: write this dispatch's K/V into the pool, then
    attend, through either the ``"gather"`` path (gather the pages into a
    logical buffer, dequantized on read for a quantized pool, mask, softmax:
    the JAX package's ``"xla"`` oracle) or the ``"paged_kernel"`` path (the
    Hopper kernels of `ops/paged_attention.py`, JAX's ``"pallas_paged"``).
    With no page table it is the contiguous layout's: one ``[S, L, Hkv, D]``
    row per slot, written per row at its position and read plainly.
  - `dense_cache_attention`: the cached prefill's attention over a dense
    per-slot K/V view (`utils/operations.gather_pages`), which holds the
    prompt's own K/V at full precision whatever the pool stores.
  - `attend`: a decoder layer's attention through whichever of the modes
    above its caches select (the models' one entry).
  - `DecodeCache`, `update_decode_cache` and `decode_cache_mask`: the static
    `Generator`'s cache (JAX's `update_decode_cache`), ``[B, L, Hkv, D]``
    per layer with ONE physical write index shared by the batch and a
    persistent ``[B, L]`` pad mask for left-padded prompts. The physical
    index is not the rotary position: a left-padded row's positions come
    from its mask, while every row's cache slots advance together from 0.

Shapes follow [batch, seq, heads, head_dim] throughout.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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


def segment_mask(q_seg, kv_seg):
    """Packed-sequence attention mask: [B, Sq] x [B, Skv] ids -> [B, 1, Sq,
    Skv] bool, True where the ids match (the JAX package's definition, in
    `parallel/ring_attention.py`)."""
    return q_seg[:, None, :, None] == kv_seg[:, None, None, :]


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
    bias=None,
    causal: bool = False,
    scale: Optional[float] = None,
    implementation: Optional[str] = None,
    segment_ids=None,
):
    """Multi-head (optionally grouped-query) scaled dot-product attention.

    Args:
        q: [B, Sq, Hq, D]
        k / v: [B, Skv, Hkv, D] with Hq % Hkv == 0
        mask: optional bool, [B, 1|Hq, Sq, Skv] or [B, Skv]; True = attend.
        bias: optional additive [1|B, Hq, Sq, Skv] score bias (T5's relative
            positions), cast to the scores' dtype and added after scaling,
            before the causal mask and `mask`. Like a mask, it keeps the
            call on the plain path.
        causal: apply a bottom-right causal mask.
        scale: defaults to 1/sqrt(D).
        implementation: ``"xla"`` (the plain einsum-softmax path, JAX's name
            for it), ``"flash"`` (the kernels of `ops/flash_attention.py`,
            which take no mask), or None: `use_flash` decides. With None,
            ``ACCELERATE_TPU_ATTENTION_IMPL=xla|flash`` forces one for every
            call, as in the JAX package. `LAST_DISPATCH` records the choice.
        segment_ids: optional [B, S] int ids of packed sequences (needs
            Sq == Skv); attention stays within equal ids. Such a call takes
            the plain path, as a masked one does.
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
    if segment_ids is not None and sq != skv:
        raise ValueError(f"segment_ids requires Sq == Skv (self-attention packing), got ({sq}, {skv})")
    if implementation == "flash" and (bias is not None or mask is not None or segment_ids is not None):
        blocked = "bias" if bias is not None else ("mask" if mask is not None else "segment_ids")
        raise ValueError(
            f"implementation='flash' cannot honor a {blocked} argument: the kernels thread only "
            "`causal`. Drop implementation= to let the dispatcher pick the plain path, or "
            "pass implementation='xla'."
        )
    masked = bias is not None or mask is not None or segment_ids is not None
    if use_flash(implementation, masked, sq, skv, causal, q.is_cuda):
        LAST_DISPATCH = "flash"
        return flash_attention(q, k, v, causal=causal, scale=scale)
    LAST_DISPATCH = "xla"
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)  # [B, H, S, D]
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale  # [B, H, Sq, Skv]
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    neg = torch.finfo(scores.dtype).min
    if causal:
        scores = scores.masked_fill(~make_causal_mask(sq, skv, q.device), neg)
    if mask is not None:
        if mask.ndim == 2:  # [B, Skv] padding mask
            mask = mask[:, None, None, :]
        scores = scores.masked_fill(~mask.bool(), neg)
    if segment_ids is not None:
        scores = scores.masked_fill(~segment_mask(segment_ids, segment_ids), neg)
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
        k_pool / v_pool: [num_pages, page_size, Hkv, D], updated in place;
            with ``page_table=None``, the contiguous layout's per-slot rows
            [B, L, Hkv, D] instead (JAX's non-paged `update_slot_cache`).
        positions: [B, s] absolute positions; query j of row i attends
            ``cols <= positions[i, j]``.
        page_table: [B, pages_per_slot] int32, or None for the contiguous
            layout.
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
    if page_table is None:
        return _contiguous_slot_attention(q, k, v, k_pool, v_pool, positions, attention_impl, k_scale)
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


def _contiguous_slot_attention(q, k, v, k_rows, v_rows, positions, attention_impl, k_scale):
    """The contiguous slot cache: row i's K/V land at its own clipped
    positions in its ``[L, Hkv, D]`` row, and query j attends
    ``cols <= pos[i, j]`` (stale K/V of a slot's earlier occupant lies
    above every position and is never seen). The read is the plain one."""
    if k_scale is not None or k_rows.dtype in (torch.int8, torch.float8_e4m3fn):
        kv = "int8" if k_rows.dtype == torch.int8 else "fp8_e4m3"
        raise ValueError(
            f"kv_cache_dtype={kv!r} requires the paged slot cache "
            "(page_size > 0); the contiguous layout has no page-scale pool"
        )
    if attention_impl == "paged_kernel":
        raise ValueError(
            "attention_impl='paged_kernel' requires the paged KV cache "
            "(paged=True); the contiguous layout has no page table to walk"
        )
    pos = positions.clamp(0, k_rows.shape[1] - 1).long()
    rows = torch.arange(k_rows.shape[0], device=k_rows.device)[:, None]
    k_rows[rows, pos] = k.to(k_rows.dtype)
    v_rows[rows, pos] = v.to(v_rows.dtype)
    return _attend_logical(q, k_rows, v_rows, pos)


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


@dataclass
class DecodeCache:
    """The static `Generator`'s K/V cache: per layer a ``[B, L, Hkv, D]``
    key and value buffer, ONE physical write index shared by the batch and
    the layers (JAX keeps a `cache_index` per layer, all advanced together),
    and, after a masked prefill, the persistent ``[B, L]`` bool pad mask. An
    encoder-decoder also keeps, per decoder layer, the cross-attention K and
    V it projected from the encoder's output on its first decode call
    (`cross`, layer -> (k, v)), which every later step reads back.

    `index` is a host integer: every write advances it by a number the host
    already knows (the block's length), and a speculative rewind by the
    accepted length the loop reads back anyway, so no write or read of the
    cache ever waits on the device."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    index: int = 0
    pad_mask: Optional[torch.Tensor] = None
    cross: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = field(default_factory=dict)
    #: [B, s, 1, 1] bool, True for a query of the current masked block that
    #: sees no key (a pad of a left-padded prompt); None for other blocks.
    blind: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, num_layers: int, batch: int, max_length: int, kv_heads: int, head_dim: int,
               dtype: torch.dtype, device) -> "DecodeCache":
        """Zeroed buffers for `num_layers` layers of `batch` rows of
        `max_length` positions."""
        shape = (batch, max_length, kv_heads, head_dim)
        return cls(
            keys=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)],
            values=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)],
        )

    @property
    def max_length(self) -> int:
        return self.keys[0].shape[1]

    def rewind(self, delta: int) -> None:
        """Roll the write index back by `delta` (JAX's `_rewind_cache_index`):
        the speculative accept step. The rejected rows stay in the buffers,
        unreachable: the mask stops at ``index + s`` and the next block's
        writes start at the rewound index, covering them before any query
        can see them."""
        self.index -= int(delta)


def decode_cache_mask(cache: DecodeCache, s: int, pad_mask=None) -> torch.Tensor:
    """The mask of JAX's `update_decode_cache` for an `s`-token block written
    at ``cache.index``, cut to the written prefix: ``[B, 1, s, index + s]``
    bool, query i seeing ``cols <= index + i``. The columns past ``index +
    s`` are never written yet, so reading only the prefix drops nothing but
    exact zeros of the f32 softmax.

    `pad_mask` ([B, s], 1 = a real token; the prompt's attention_mask at
    prefill) is stored into the cache's ``[B, L]`` pad mask at the index and
    ANDed into this and every later block's mask, so a left-padded row
    never attends its pads."""
    b = cache.keys[0].shape[0]
    device = cache.keys[0].device
    cur = cache.index
    if pad_mask is not None:
        if pad_mask.ndim != 2:
            raise ValueError(
                f"the decode-cache path persists a [B, S] key-padding mask; got a "
                f"rank-{pad_mask.ndim} mask. Pass attention_mask as [batch, seq] "
                f"(1 = real token), the HF padding-mask shape."
            )
        if cache.pad_mask is None:
            cache.pad_mask = torch.ones((b, cache.max_length), dtype=torch.bool, device=device)
        cache.pad_mask[:, cur : cur + s] = pad_mask.bool()[:, : cache.max_length - cur]
    end = min(cur + s, cache.max_length)
    rows = cur + torch.arange(s, device=device)[:, None]
    cols = torch.arange(end, device=device)[None, :]
    mask = (cols <= rows)[None, None].expand(b, 1, s, end)
    if cache.pad_mask is not None:
        mask = mask & cache.pad_mask[:, None, None, :end]
    cache.blind = None if pad_mask is None else ~mask.any(dim=-1).permute(0, 2, 1)[..., None]
    return mask


def update_decode_cache(cache: DecodeCache, layer: int, k, v):
    """Write layer `layer`'s [B, s, Hkv, D] block at ``cache.index`` (the
    index itself advances once per forward, after the last layer) and return
    the written prefix ``[B, index + s, Hkv, D]`` of its K and V.

    A block that would run past `max_length` keeps only the rows that fit.
    That happens only to the tail of a speculative loop's last verify block,
    whose rows past the cache are drafts no emitted token depends on. (JAX's
    `dynamic_update_slice` clamps the block's start instead, which writes
    the block over earlier rows and changes the loop's last tokens.)"""
    cur, length = cache.index, cache.max_length
    end = min(cur + k.shape[1], length)
    k_cache, v_cache = cache.keys[layer], cache.values[layer]
    k_cache[:, cur:end] = k[:, : end - cur].to(k_cache.dtype)
    v_cache[:, cur:end] = v[:, : end - cur].to(v_cache.dtype)
    return k_cache[:, :end], v_cache[:, :end]


def decode_cache_attention(q, k, v, cache: DecodeCache, layer: int, mask, bias=None, scale=None):
    """The Generator's attention: write the block into the decode cache and
    attend the written prefix under `mask` (`decode_cache_mask`) and an
    optional score `bias` over the same prefix, the plain path, as JAX's
    masked `dot_product_attention` never takes the flash gate.

    A query that sees no key (`cache.blind`: a pad of a left-padded prompt)
    gets what JAX's attention over the whole ``[B, L]`` cache gives it: the
    softmax's uniform weights 1/L over every slot, the unwritten zeros
    included, not over the written prefix only. Its output feeds no emitted
    token, but a MoE layer routes the pad with the rest, so its expert
    choice, and the capacity left to the real tokens, must be JAX's."""
    k_all, v_all = update_decode_cache(cache, layer, k, v)
    out = dot_product_attention(q, k_all, v_all, mask=mask, bias=bias, scale=scale)
    if cache.blind is None:
        return out
    values = cache.values[layer]  # [B, L, Hkv, D]
    uniform = torch.full((values.shape[1],), 1.0 / values.shape[1], device=values.device).to(values.dtype)
    mean = torch.einsum("l,blhd->bhd", uniform, values)
    mean = mean.repeat_interleave(q.shape[2] // values.shape[2], dim=1)[:, None].to(out.dtype)  # [B, 1, Hq, D]
    return torch.where(cache.blind, mean, out)


def attend(q, k, v, positions, attention_mask=None, kv_pool=None, page_table=None, attention_impl="gather",
           kv_cache=None, decode_cache=None):
    """[B, S, Hq, D] q and [B, S, Hkv, D] k, v through the mode the caches
    select: `kv_pool` (the engine's pools, paged with `page_table` or
    contiguous without), `decode_cache` (``(cache, layer index)``, with
    `attention_mask` the block's decode mask), `kv_cache` (the cached
    prefill's dense pair), or none: the causal forward with an optional
    [B, S] padding mask."""
    if kv_pool is not None:
        k_pool, v_pool, *scales = kv_pool
        return slot_cache_attention(q, k, v, k_pool, v_pool, positions, page_table, attention_impl, *scales)
    if decode_cache is not None:
        return decode_cache_attention(q, k, v, *decode_cache, attention_mask)
    if kv_cache is not None:
        return dense_cache_attention(q, k, v, kv_cache[0], kv_cache[1], positions)
    return dot_product_attention(q, k, v, mask=attention_mask, causal=True)
