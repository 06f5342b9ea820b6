"""accelerate_tpu_torch: the PyTorch/CUDA port of `accelerate_tpu`.

A package of its own beside the JAX one, for an NVIDIA Hopper card. This
slice serves Llama through the paged continuous-batching engine
(`serving.ContinuousBatcher`), whose decode and speculative-verify attention
run in hand-written CUDA kernels (`csrc/paged_attention.cu`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel is replaced by its plain PyTorch version. The package
imports ``torch`` and never ``jax`` or anything of `accelerate_tpu`.
"""

from .device import resolve_device
from .models import create_llama_model, create_named_model
from .serving import ContinuousBatcher, EngineClosed, QueueFull, Request, RequestResult

__all__ = [
    "ContinuousBatcher",
    "EngineClosed",
    "QueueFull",
    "Request",
    "RequestResult",
    "create_llama_model",
    "create_named_model",
    "resolve_device",
]
