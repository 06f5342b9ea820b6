"""Moving batches to the device, and the paged insert's page moves (the parts
of `accelerate_tpu/utils/operations.py` one process needs).

The page helpers work on the serving engine's per-layer pools: a list with
one ``(k_pool, v_pool)`` pair per layer, ``[num_pages, page_size, Hkv, D]``
each, or ``(k_pool, v_pool, k_scale, v_scale)`` for an int8/fp8 pool with its
``[num_pages, Hkv]`` f32 scales. They are the counterparts of JAX's
`tree_gather_pages`, `tree_zero_cache_tail` and `tree_scatter_pages`, which
walk a flax cache pytree instead.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.quantization import dequantize_kv_pages, kv_spec_for_dtype, quantize_kv_pages

DenseCache = List[Tuple[torch.Tensor, torch.Tensor]]


def send_to_device(batch, device):
    """`batch` with every tensor and numpy array moved to `device` as a
    tensor, through nested dicts, lists and tuples; other leaves as given."""
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(batch).to(device)
    if isinstance(batch, dict):
        return {k: send_to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(send_to_device(v, device) for v in batch)
    return batch


def gather_pages(pools: Sequence[tuple], page_ids, dtype: torch.dtype) -> DenseCache:
    """A batch-1 dense K/V view of pool pages, per layer: the pages
    `page_ids` ([P] ints) laid end to end as ``[1, P * page_size, Hkv, D]``
    in `dtype`, dequantized with their page scales for a quantized pool.
    The result is a new tensor the caller may write."""
    ids = torch.as_tensor(page_ids, device=pools[0][0].device).long().reshape(-1)
    dense = []
    for k_pool, v_pool, *scales in pools:
        _, ps, hkv, d = k_pool.shape
        pair = []
        for pool, scale in zip((k_pool, v_pool), scales or (None, None)):
            pages = pool[ids]  # [P, ps, Hkv, D]
            pages = pages.to(dtype) if scale is None else dequantize_kv_pages(pages, scale[ids], dtype)
            pair.append(pages.reshape(1, ids.numel() * ps, hkv, d))
        dense.append(tuple(pair))
    return dense


def zero_cache_tail(dense: DenseCache, valid_len: int) -> DenseCache:
    """Zero every dense K/V row at positions >= `valid_len`, in place. The
    gathered view carries a recycled page's stale content past the prompt;
    masked, it is never attended, but a quantized scatter would fold it into
    the boundary page's amax scale and coarsen the real rows."""
    for pair in dense:
        for cache in pair:
            cache[:, valid_len:] = 0
    return dense


def scatter_pages(pools: Sequence[tuple], dense: DenseCache, page_ids) -> None:
    """Write a batch-1 dense view back into pool pages, in place (the
    inverse of `gather_pages`): page j of the view lands at pool page
    ``page_ids[j]``. A quantized pool's pages are quantized whole at their
    per-head amax and their scales written beside them. Callers that must
    not rewrite shared prefix pages point those entries at the scratch
    page."""
    ids = torch.as_tensor(page_ids, device=pools[0][0].device).long().reshape(-1)
    for (k_pool, v_pool, *scales), pair in zip(pools, dense):
        for pool, scale, cache in zip((k_pool, v_pool), scales or (None, None), pair):
            blocks = cache[0].reshape(ids.numel(), *pool.shape[1:])
            if scale is None:
                pool[ids] = blocks.to(pool.dtype)
            else:
                q, page_scale = quantize_kv_pages(blocks, kv_spec_for_dtype(pool.dtype))
                pool[ids] = q
                scale[ids] = page_scale
