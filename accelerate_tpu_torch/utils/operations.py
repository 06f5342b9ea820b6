"""Moving batches to the device, the collectives across processes, and the
paged insert's page moves (the port of `accelerate_tpu/utils/operations.py`).

The collectives (`gather`, `gather_object`, `broadcast`,
`broadcast_object_list`, `reduce`, `pad_across_processes`) run over the
`PartialState`'s process group through `torch.distributed`: NCCL on the
card, gloo on the CPU. `gather`, `gather_object`, `reduce` and
`pad_across_processes` take a `group` (None: every process); the
`Accelerator`'s methods pass the "data" ranks under a "model" axis, whose
ranks of one data shard hold the same rows. Each takes a tensor, a numpy array or nested dicts,
lists and tuples of them, returns the same kinds, and is the identity with
one process. `pad_input_tensors`, `slice_tensors` and `concatenate` are
pure.

Debug mode (``ACCELERATE_TPU_DEBUG_MODE=1``, `PartialState.debug`) puts
JAX's `verify_operation` before `gather`, `broadcast`, `reduce` and
`pad_across_processes`: one `all_gather_object` of every process's shapes and
dtypes, and `DistributedOperationException` with JAX's message on every
process when they part, where the collective itself would hang or fail.
`gather_object` and `broadcast_object_list` take objects of any size and
are only re-raised with context (`chained_operation`), as in JAX.

The page helpers work on the serving engine's per-layer pools: a list with
one ``(k_pool, v_pool)`` pair per layer, ``[num_pages, page_size, Hkv, D]``
each, or ``(k_pool, v_pool, k_scale, v_scale)`` for an int8/fp8 pool with its
``[num_pages, Hkv]`` f32 scales. They are the counterparts of JAX's
`tree_gather_pages`, `tree_zero_cache_tail` and `tree_scatter_pages`, which
walk a flax cache pytree instead.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.quantization import dequantize_kv_pages, kv_spec_for_dtype, quantize_kv_pages

DenseCache = List[Tuple[torch.Tensor, torch.Tensor]]


class DistributedOperationException(Exception):
    """Raised when processes call a collective with parted shapes (JAX's,
    in debug mode)."""


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


def is_tensor_like(t) -> bool:
    return isinstance(t, (torch.Tensor, np.ndarray))


def honor_type(obj, generator):
    """`generator`'s items as `obj`'s sequence type (namedtuples too)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*list(generator))
    return type(obj)(generator)


def recursively_apply(func: Callable, data, *args, test_type=is_tensor_like, error_on_other_type: bool = False,
                      **kwargs):
    """`func` over every leaf of `data` that passes `test_type`, through
    dicts, lists and tuples; other leaves as given, or a TypeError."""
    if isinstance(data, (tuple, list)):
        return honor_type(data, (recursively_apply(func, o, *args, test_type=test_type,
                                                   error_on_other_type=error_on_other_type, **kwargs) for o in data))
    if isinstance(data, Mapping):
        return type(data)({k: recursively_apply(func, v, *args, test_type=test_type,
                                                error_on_other_type=error_on_other_type, **kwargs)
                           for k, v in data.items()})
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(f"Unsupported type {type(data)} passed to {func.__name__}: only nested lists, tuples, "
                        "dicts of tensors or numpy arrays are supported")
    return data


def _state():
    from ..state import PartialState

    return PartialState()


def _num_processes() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _collective(fn):
    """Run ``fn(tensor) -> tensor`` on a leaf on the group's device and
    return the result as the leaf's kind: numpy in, numpy out; a tensor
    back on its own device."""

    def apply(t):
        as_numpy = isinstance(t, np.ndarray)
        tensor = torch.as_tensor(t)
        home = tensor.device
        out = fn(tensor.to(_state().device).contiguous())
        return out.cpu().numpy() if as_numpy else out.to(home)

    return apply


def get_data_structure(data):
    """Each tensor leaf's shape and dtype, JAX's skeleton of a tree (dtypes
    by their numpy names)."""

    def _info(t):
        dtype = str(t.dtype).replace("torch.", "")
        return {"shape": tuple(t.shape), "dtype": dtype}

    return recursively_apply(_info, data)


def verify_operation(function):
    """In debug mode across processes, compare the first argument's
    structure on every process before running the collective."""

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        if _num_processes() == 1 or not _state().debug:
            return function(*args, **kwargs)
        operation = f"{function.__module__}.{function.__name__}"
        tensor = kwargs.get("tensor", args[0] if args else None)
        output = [None] * _num_processes()
        dist.all_gather_object(output, get_data_structure(tensor))
        if output[0] is not None and not all(x == output[0] for x in output):
            process_shape_str = "\n  - ".join([f"Process {i}: {s}" for i, s in enumerate(output)])
            raise DistributedOperationException(
                "Cannot apply desired operation due to shape mismatches. All shapes across devices must be "
                f"valid.\n\nOperation: `{operation}`\nInput shapes:\n  - {process_shape_str}")
        return function(*args, **kwargs)

    return wrapper


def chained_operation(function):
    """Re-raise a `DistributedOperationException` with the operation named."""

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        try:
            return function(*args, **kwargs)
        except DistributedOperationException as e:
            operation = f"{function.__module__}.{function.__name__}"
            raise DistributedOperationException(
                f"Error found while calling `{operation}`. Please see the earlier error for more details.") from e

    return wrapper


def _group_size(group) -> int:
    return _num_processes() if group is None else dist.get_world_size(group)


def _all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(_group_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


@verify_operation
def gather(tensor, group=None):
    """Every process's leaves concatenated along dim 0, in process order, on
    every process (a 0-d leaf becomes one row per process); with `group`,
    that group's processes only. The leaves must have one shape across the
    processes (`pad_across_processes` first when not)."""
    if _group_size(group) == 1:
        return tensor

    def _one(t):
        return torch.cat([p.reshape(1) if p.dim() == 0 else p for p in _all_gather(t, group)], dim=0)

    return recursively_apply(_collective(_one), tensor, error_on_other_type=True)


@chained_operation
def gather_object(object: Any, group=None) -> list:
    """Picklable objects from every process (or `group`'s), as one list in
    process order; a process's list is spliced in, any other object
    appended."""
    if _group_size(group) == 1:
        return list(object) if isinstance(object, list) else [object]
    gathered = [None] * _group_size(group)
    dist.all_gather_object(gathered, object, group=group)
    out = []
    for obj in gathered:
        if isinstance(obj, list):
            out.extend(obj)
        else:
            out.append(obj)
    return out


@verify_operation
def broadcast(tensor, from_process: int = 0):
    """`from_process`'s leaves, on every process."""
    if _num_processes() == 1:
        return tensor

    def _one(t):
        t = t.clone()
        dist.broadcast(t, src=from_process)
        return t

    return recursively_apply(_collective(_one), tensor, error_on_other_type=True)


@chained_operation
def broadcast_object_list(object_list: list, from_process: int = 0) -> list:
    """`from_process`'s picklable objects written into `object_list` in
    place on every process; returns it."""
    if _num_processes() > 1:
        dist.broadcast_object_list(object_list, src=from_process)
    return object_list


@verify_operation
def reduce(tensor, reduction: str = "mean", scale: float = 1.0, group=None):
    """The leaves summed (``"sum"``) or averaged (``"mean"``) over the
    processes (or `group`'s), times `scale`, on every process."""
    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
    n = _group_size(group)

    def _one(t):
        t = t.clone()
        if n > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            if reduction == "mean":
                t = t / n
        return t * scale

    return recursively_apply(_collective(_one), tensor, error_on_other_type=True)


@verify_operation
def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False, group=None):
    """Each leaf padded with `pad_index` along `dim` to the largest size any
    process (of `group`, where given) holds there (at the front with
    `pad_first`), so that `gather` can take it."""
    if _group_size(group) == 1:
        return tensor

    def _one(t):
        if t.dim() == 0 or dim >= t.dim():
            return t
        sizes = torch.stack(_all_gather(torch.tensor(t.shape, device=t.device), group))
        max_size = int(sizes[:, dim].max())
        if max_size == t.shape[dim]:
            return t
        new_shape = list(t.shape)
        new_shape[dim] = max_size
        out = t.new_full(new_shape, pad_index)
        start = max_size - t.shape[dim] if pad_first else 0
        out.narrow(dim, start, t.shape[dim]).copy_(t)
        return out

    return recursively_apply(_collective(_one), tensor, error_on_other_type=True)


def pad_input_tensors(tensor, batch_size: int, num_processes: int, dim: int = 0):
    """Each leaf padded along `dim` by repeating its last entry until
    `num_processes` divides its size."""

    def _one(t):
        remainder = t.shape[dim] % num_processes
        if remainder == 0:
            return t
        index = [t.shape[dim] - 1] * (num_processes - remainder)
        if isinstance(t, np.ndarray):
            return np.concatenate([t, np.take(t, index, axis=dim)], axis=dim)
        return torch.cat([t, t.index_select(dim, torch.tensor(index, device=t.device))], dim=dim)

    return recursively_apply(_one, tensor, error_on_other_type=True)


def slice_tensors(data, tensor_slice):
    """Every leaf indexed by `tensor_slice`."""
    return recursively_apply(lambda t: t[tensor_slice], data)


def concatenate(data: list, dim: int = 0):
    """A list of same-structure trees concatenated leaf by leaf."""
    if isinstance(data[0], (tuple, list)):
        return honor_type(data[0], (concatenate([d[i] for d in data], dim=dim) for i in range(len(data[0]))))
    if isinstance(data[0], Mapping):
        return type(data[0])({k: concatenate([d[k] for d in data], dim=dim) for k in data[0].keys()})
    if not is_tensor_like(data[0]):
        raise TypeError(f"Can only concatenate tensors but got {type(data[0])}")
    if isinstance(data[0], np.ndarray):
        return np.concatenate(data, axis=dim)
    return torch.cat(data, dim=dim)


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
