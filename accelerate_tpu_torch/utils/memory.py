"""Running out of device memory and trying again (the port of
`accelerate_tpu/utils/memory.py`).

`find_executable_batch_size` halves the batch size each time the wrapped
function runs out of memory, with JAX's decorator contract and messages, so
a training script ports unchanged. On the card the signal is
`torch.cuda.OutOfMemoryError`, or a `RuntimeError` with CUDA's or the
caching allocator's "out of memory" message; what the next attempt needs
back is the caching allocator's memory, which `release_memory` (and
`Accelerator.free_memory`) return with `torch.cuda.empty_cache()`.
"""

from __future__ import annotations

import functools
import gc
import inspect

import torch

#: Messages of an out-of-memory error: the caching allocator's ("CUDA out of
#: memory. Tried to allocate ..."), CUDA's own (cudaErrorMemoryAllocation,
#: "out of memory") and cuBLAS's allocation failure.
OOM_MARKERS = ("out of memory", "CUBLAS_STATUS_ALLOC_FAILED")


def _empty_cache():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def release_memory(*objects):
    """Drop the references in `objects` (returned as as many `None`s), run
    the garbage collector and hand the caching allocator's free blocks back
    to the card. Use as ``a, b = release_memory(a, b)``."""
    if not isinstance(objects, list):
        objects = list(objects)
    for i in range(len(objects)):
        objects[i] = None
    gc.collect()
    _empty_cache()
    return objects


def is_oom_exception(exception: BaseException) -> bool:
    """True when `exception` is the card running out of memory."""
    if isinstance(exception, torch.cuda.OutOfMemoryError):
        return True
    if isinstance(exception, RuntimeError) and len(exception.args) == 1:
        return any(marker in exception.args[0] for marker in OOM_MARKERS)
    return False


def find_executable_batch_size(function=None, starting_batch_size: int = 128):
    """Decorator: calls ``function(batch_size, *args, **kwargs)`` from
    `starting_batch_size`, halving the batch size after each out-of-memory
    error until a call returns; raises when it reaches zero. The caller
    passes the other arguments only: the decorator supplies the batch size.

        @find_executable_batch_size(starting_batch_size=64)
        def train(batch_size): ...
        train()
    """
    if function is None:
        return functools.partial(find_executable_batch_size, starting_batch_size=starting_batch_size)

    batch_size = [starting_batch_size]

    @functools.wraps(function)
    def decorator(*args, **kwargs):
        params = list(inspect.signature(function).parameters.keys())
        if len(params) < (len(args) + 1):
            arg_str = ", ".join([f"{arg}={value}" for arg, value in zip(params[1:], args[1:])])
            raise TypeError(
                f"Batch size was passed into `{function.__name__}` as the first argument when called."
                f"Remove this as the decorator already does so: `{function.__name__}({arg_str})`"
            )
        while True:
            if batch_size[0] == 0:
                raise RuntimeError("No executable batch size found, reached zero.")
            try:
                return function(batch_size[0], *args, **kwargs)
            except Exception as e:
                if not is_oom_exception(e):
                    raise
            # Outside the handler the failed attempt's frames, and the
            # tensors they held, are unreachable: free them and their cached
            # blocks before the next attempt.
            gc.collect()
            _empty_cache()
            batch_size[0] //= 2

    return decorator
