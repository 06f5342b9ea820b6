"""accelerate_tpu_torch: the PyTorch/CUDA port of `accelerate_tpu`.

A package of its own beside the JAX one, for an NVIDIA Hopper card. It
generates from Llama with `generate` and the static `Generator`
(`generation.py`: prefill and a decode loop over a contiguous decode cache,
sampling, repetition penalty, n-gram speculative decoding), serves it
through the continuous-batching engine (`serving.ContinuousBatcher`), whose
paged decode and speculative-verify attention run in hand-written CUDA
kernels (`csrc/paged_attention.cu`), with int8 weights and int8 or fp8 KV
pages on request (`ops/quantization.py`), or over a contiguous per-slot
cache with a per-request repetition penalty, and trains it
through `Accelerator.prepare` and the fused `train_step`, whose attention
runs forward and backward in hand-written flash kernels
(`csrc/flash_attention.cu`), in f32, bf16 or fp16 with dynamic loss
scaling, and saves and restores the whole training state
(`Accelerator.save_state` / `load_state`, `checkpointing.py`). Every
in-tree layer can be checkpointed (`CompilationConfig(remat_policy=...)`,
`ops/remat.py`), which runs the flash forward again in the backward. BERT
(`models/bert.py`) trains through the same surface, with JSON/CSV trackers
(`tracking.py`) and `gather_for_metrics`: `python -m
accelerate_tpu_torch.examples.nlp_example` is the twin of the JAX
package's `examples/nlp_example.py`. T5 (`models/t5.py`, T0pp-11B's
config) trains through the same surface and generates through
`Seq2SeqGenerator`; `utils/hf_loading.py` loads Hugging Face checkpoints
into every family and writes them back. Mixtral (`models/mixtral.py`,
Mixtral-8x7B's config) trains and generates through the same entry points,
its MLP a top-k mixture of experts (`parallel/expert.py`) whose router
losses ride beside the loss. The engine and the `Accelerator` carry JAX's
telemetry (`telemetry/`: metrics, spans, the flight recorder, the step
timeline, the profiler, the exporters) and its trace guard
(`analysis/trace_guard.py`, which catches kernel builds and host syncs in a
steady-state step). Across processes (one per card, NCCL; gloo on the
CPU) it trains data parallel or sharded as JAX's FSDP/ZeRO strategies place
a model (`FullyShardedDataParallelPlugin`, `ParallelismConfig`,
`parallel/fsdp.py`), over the global batch; `debug_launcher` runs a
function in several CPU processes. The rest of JAX's one-process
`Accelerator` surface is here too: the scheduler's step across processes,
`autocast`, `clip_grad_value_`, `save_model`, `free_memory` with
`find_executable_batch_size` (`utils/memory.py`), triggers, the
save/load pre-hooks, `DataLoaderDispatcher`, the synchronized generators
(`rng_types`), the kwargs handlers, `get_logger` (`logging.py`) and the
trackers beyond JSON and CSV; `examples/` holds twins of JAX's
`cv_example` and of its `by_feature` memory, early-stopping and tracking
scripts.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel is replaced by its plain PyTorch version. The package
imports ``torch`` and never ``jax`` or anything of `accelerate_tpu`.
"""

from .accelerator import Accelerator
from .checkpointing import CheckpointManager
from .data_loader import (
    BatchSampler,
    DataLoaderDispatcher,
    SeedableRandomSampler,
    SimpleDataLoader,
    prepare_data_loader,
    skip_first_batches,
)
from .device import resolve_device
from .generation import GenerationConfig, Generator, Seq2SeqGenerator, generate
from .launchers import debug_launcher
from .logging import get_logger
from .modeling import Model, PreparedModel
from .models import create_llama_model, create_mixtral_model, create_named_model
from .ops.quantization import KV_CACHE_DTYPES, WEIGHT_DTYPES, Int8Linear, quantize_model_int8
from .serving import ContinuousBatcher, EngineClosed, QueueFull, Request, RequestResult
from .telemetry import MetricsRegistry, ProfilerManager, StepTimeline, TrackerBridge
from .utils import (
    AutocastKwargs,
    CompilationConfig,
    DataLoaderConfiguration,
    DistributedDataParallelKwargs,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    ParallelismConfig,
    ProjectConfiguration,
    find_executable_batch_size,
    set_seed,
)

__all__ = [
    "Accelerator",
    "AutocastKwargs",
    "BatchSampler",
    "CheckpointManager",
    "CompilationConfig",
    "ContinuousBatcher",
    "DataLoaderConfiguration",
    "DataLoaderDispatcher",
    "DistributedDataParallelKwargs",
    "EngineClosed",
    "FP8RecipeKwargs",
    "FullyShardedDataParallelPlugin",
    "GradScalerKwargs",
    "GenerationConfig",
    "Generator",
    "GradientAccumulationPlugin",
    "InitProcessGroupKwargs",
    "Int8Linear",
    "KV_CACHE_DTYPES",
    "MetricsRegistry",
    "Model",
    "ParallelismConfig",
    "PreparedModel",
    "ProfilerManager",
    "ProjectConfiguration",
    "QueueFull",
    "Request",
    "RequestResult",
    "SeedableRandomSampler",
    "Seq2SeqGenerator",
    "SimpleDataLoader",
    "StepTimeline",
    "TrackerBridge",
    "WEIGHT_DTYPES",
    "create_llama_model",
    "create_mixtral_model",
    "create_named_model",
    "debug_launcher",
    "find_executable_batch_size",
    "generate",
    "get_logger",
    "prepare_data_loader",
    "quantize_model_int8",
    "resolve_device",
    "set_seed",
    "skip_first_batches",
]
