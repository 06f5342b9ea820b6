"""The user-facing training facade (the port of the one-process path of
`accelerate_tpu/accelerator.py`).

    accelerator = Accelerator(mixed_precision="bf16")  # or "fp16", with loss scaling, or "fp8"
    model, optimizer, loader, scheduler = accelerator.prepare(model, optimizer, loader, schedule)
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    for batch in loader:
        loss = step_fn(batch)
        scheduler.step()

Checkpoints: ``Accelerator(project_config=ProjectConfiguration(project_dir=...,
automatic_checkpoint_naming=True))``, then `save_state()` every so often and,
in a fresh process, `load_state("latest")` and
`skip_first_batches(loader, steps_done_in_the_pass)`.

or the eager surface, as in the JAX package:

    with accelerator.accumulate(model):
        loss = accelerator.backward(model.loss, batch)
        accelerator.clip_grad_norm_(max_norm=1.0)
        optimizer.step()
        optimizer.zero_grad()

Activation checkpointing: ``Accelerator(compilation_config=CompilationConfig(
remat_policy="full"))`` checkpoints every in-tree layer (`ops/remat.py`).
fp8: ``Accelerator(mixed_precision="fp8", kwargs_handlers=[FP8RecipeKwargs(...)])``
runs every linear layer's product in fp8 (`ops/fp8.py`), the rest in bf16.
Metrics: ``Accelerator(log_with="json", project_dir=...)`` (or
"tensorboard", or any installed tracker), then `init_trackers`, `log` and
`end_training`, and `gather_for_metrics`.

The rest of JAX's surface: `step_scheduler_with_optimizer` (a prepared
scheduler advances `num_processes` steps per optimizer step unless
`split_batches`), `kwargs_handlers` (`AutocastKwargs`,
`InitProcessGroupKwargs`, `DistributedDataParallelKwargs`,
`GradScalerKwargs`, `FP8RecipeKwargs`), `dataloader_config`
(`DataLoaderConfiguration`, with `DataLoaderDispatcher`), `rng_types`,
`device_placement`, `autocast()`, `clip_grad_value_`, `save_model` (sharded
safetensors with an index), `free_memory`/`clear` (with
`utils.memory.find_executable_batch_size`), `set_trigger`/`check_trigger`,
`join_uneven_inputs`, the save and load pre-hooks, and
`local_main_process_first`/`on_local_main_process`.

Telemetry, as JAX's (`telemetry/`): `accelerator.telemetry` (a
`MetricsRegistry`), `.tracer` (from ``tracer=`` or the env protocol
``ACCELERATE_TPU_TRACE_DIR``/``_ID``/``_PARENT``; with a trace directory the
exit dumps, the kernel-build listener and the hang watchdog,
``ACCELERATE_TPU_HANG_DEADLINE_S`` seconds, 300 by default, arm with it),
`.timeline` (a `StepTimeline` over every `train_step()` call: the
"dispatch" phase, a ``train.step`` span, goodput), `.profiler` (a
`ProfilerManager` armed by ``ACCELERATE_TPU_PROFILE_DIR``), `profile()` and
`save_memory_profile()`; `save_state`/`load_state` run in
``checkpoint.save``/``checkpoint.load`` spans and charge the goodput
ledger's "checkpoint"/"restart" causes. ``Accelerator(analyze=True)`` wraps
every `train_step()` in a raising `TraceGuard` after 2 warm-up calls: a
steady-state step that builds a kernel or makes an unsanctioned host sync
raises `TraceGuardViolation`.

More than one process (one per card, launched by torchrun or
`launchers.debug_launcher`): ``Accelerator(fsdp_plugin=FullyShardedDataParallelPlugin(
sharding_strategy=...), parallelism_config=ParallelismConfig(data=..., fsdp=...))``
(or ``ACCELERATE_TPU_USE_FSDP=1`` and the ``ACCELERATE_TPU_FSDP_*`` and
``ACCELERATE_TPU_MESH_*`` variables) places the model as JAX's mesh does
(`parallel/fsdp.py`); without a plugin the processes are data parallel.
Each process's loader yields its share of every global batch, the losses
are the global batch's, `gather`/`gather_for_metrics`/`reduce` run across
the processes, trackers write on the main process, and
`save_state`/`load_state` carry the whole state whatever the layout.

The model is an `nn.Module` (or a `modeling.Model` bundle) whose parameters
the optimizer was built over; the optimizer a `torch.optim.Optimizer`; the
loader a `SimpleDataLoader`, a torch `DataLoader` or any iterable of
batches; the scheduler a ``step -> lr`` function or a torch scheduler.
Everything runs on the card unless the caller passes ``cpu=True``.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import os
import re
import time
from typing import Callable, List, Optional

import numpy as np

import torch
from torch import nn

from . import checkpointing
from .checkpointing import CheckpointManager
from .data_loader import (
    DataLoaderDispatcher,
    DataLoaderShard,
    SimpleDataLoader,
    prepare_data_loader,
    skip_first_batches,
)
from .modeling import Model, PreparedModel
from .optimizer import AcceleratedOptimizer, GradScaler
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils import operations as ops
from .telemetry.metrics import MetricsRegistry
from .telemetry.profiler import ProfilerManager
from .telemetry.timeline import StepTimeline
from .telemetry.tracing import default_tracer
from .tracking import LOGGER_TYPE_TO_CLASS, GeneralTracker, filter_trackers
from .train_step import FusedTrainStep, detached
from .utils.dataclasses import (
    AutocastKwargs,
    CompilationConfig,
    DataLoaderConfiguration,
    DistributedDataParallelKwargs,
    DistributedType,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    KwargsHandler,
    ParallelismConfig,
    ProjectConfiguration,
    parse_flag_from_env,
)

logger = logging.getLogger(__name__)


class Accelerator:
    """Owns the device, the precision mode and the prepared objects."""

    def __init__(
        self,
        device_placement: bool = True,
        split_batches: bool = False,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        cpu: bool = False,
        dataloader_config: Optional[DataLoaderConfiguration] = None,
        log_with=None,
        project_dir: Optional[str] = None,
        project_config: Optional[ProjectConfiguration] = None,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
        parallelism_config: Optional[ParallelismConfig] = None,
        fsdp_plugin: Optional[FullyShardedDataParallelPlugin] = None,
        compilation_config: Optional[CompilationConfig] = None,
        rng_types: Optional[List[str]] = None,
        kwargs_handlers: Optional[List[KwargsHandler]] = None,
        step_scheduler_with_optimizer: bool = True,
        analyze: bool = False,
        tracer=None,
        sharded_save: Optional[bool] = None,
    ):
        # analyze=True: every train_step() is wrapped in a TraceGuard that,
        # after a warmup allowance, raises when a steady-state step builds a
        # kernel or makes an unsanctioned host sync.
        self.analyze = bool(analyze)
        self.trace_guard = None
        if self.analyze:
            from .analysis.trace_guard import TraceGuard

            self.trace_guard = TraceGuard(name="train-step", on_violation="raise")
        if sharded_save is None:
            sharded_save = parse_flag_from_env("ACCELERATE_TPU_SHARDED_SAVE")
        if sharded_save:
            raise NotImplementedError("sharded_save (a SHARDED_STATE_DICT written by each process) waits for "
                                      "ROADMAP A item 5, async and sharded checkpoints; the port saves the "
                                      "whole state from the main process")
        # The kwargs handlers, sorted by kind as JAX's are.
        self.scaler_handler = None
        self.init_handler = None
        self.autocast_handler = None
        self.ddp_handler = None
        self.fp8_recipe_handler = None
        for handler in kwargs_handlers or []:
            if isinstance(handler, GradScalerKwargs):
                self.scaler_handler = handler
            elif isinstance(handler, InitProcessGroupKwargs):
                self.init_handler = handler
            elif isinstance(handler, AutocastKwargs):
                self.autocast_handler = handler
            elif isinstance(handler, DistributedDataParallelKwargs):
                self.ddp_handler = handler  # accepted for parity: no field applies to the flat all-reduce
            elif isinstance(handler, FP8RecipeKwargs):
                self.fp8_recipe_handler = handler
        init_kwargs = {}
        if self.init_handler is not None:
            init_kwargs = {k: v for k, v in (("timeout", self.init_handler.timeout),
                                             ("backend", self.init_handler.backend),
                                             ("init_method", self.init_handler.init_method)) if v is not None}
        if fsdp_plugin is None and parse_flag_from_env("ACCELERATE_TPU_USE_FSDP"):
            fsdp_plugin = FullyShardedDataParallelPlugin()
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu,
                                      parallelism_config=parallelism_config, fsdp_plugin=fsdp_plugin, **init_kwargs)
        if self.state.mixed_precision == "fp8" and self.num_processes > 1:
            raise NotImplementedError(
                "mixed_precision='fp8' across processes waits for ROADMAP A item 3, fp8 across processes (an "
                "all-reduce of each global amax): JAX scales by the amax over the global batch, each process here by its own")
        self.device_placement = device_placement
        self.split_batches = split_batches
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(split_batches=split_batches)
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.rng_types = rng_types or ["python", "numpy"]
        self.project_configuration = project_config or ProjectConfiguration(project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        self.compilation_config = compilation_config or CompilationConfig()
        self.log_with = filter_trackers(log_with, self.logging_dir)
        self.trackers: List[GeneralTracker] = []
        # fp16's dynamic loss scaling, shared by every prepared optimizer.
        self.scaler = GradScaler(self.scaler_handler) if self.state.mixed_precision == "fp16" else None
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=gradient_accumulation_steps)
        self.gradient_state = GradientState(gradient_accumulation_plugin=gradient_accumulation_plugin)
        self._models: List[PreparedModel] = []
        self._optimizers: List[AcceleratedOptimizer] = []
        self._schedulers: List[AcceleratedScheduler] = []
        self._dataloaders: List[DataLoaderShard] = []
        self._custom_objects: list = []
        self._save_model_hooks: List[Callable] = []
        self._load_model_hooks: List[Callable] = []
        self._last_steps_per_call = 1
        self.step = 0
        self.flag_tensor = None
        self._init_telemetry(tracer)

    def _init_telemetry(self, tracer):
        """The registry, tracer, hang watchdog, step timeline, profiler and
        checkpoint instruments, built as JAX's `Accelerator.__init__` builds
        them. All host-only, and free when nothing was requested."""
        self.telemetry = MetricsRegistry()
        self.tracer = tracer if tracer is not None else default_tracer()
        self.hang_watchdog = None
        recorder = getattr(self.tracer, "recorder", None)
        if recorder is not None and getattr(recorder, "log_dir", None):
            recorder.install_exit_hooks()
            self.tracer.attach_compile_listener()
            deadline = float(os.environ.get("ACCELERATE_TPU_HANG_DEADLINE_S", "300") or 0)
            if deadline > 0:
                self.hang_watchdog = recorder.start_watchdog(deadline_s=deadline, tracer=self.tracer)
        self.timeline = StepTimeline(self.telemetry, prefix="train", tracer=self.tracer)
        self.profiler = ProfilerManager.from_env(registry=self.telemetry)
        self._m_ckpt_saves = self.telemetry.counter("checkpoint_saves_total", help="save_state() completions")
        self._m_ckpt_seconds = self.telemetry.histogram(
            "checkpoint_save_seconds", help="wall-clock per save_state()"
        )
        self._m_ckpt_loads = self.telemetry.counter(
            "checkpoint_loads_total", help="load_state() completions (restart recoveries)"
        )

    # ------------------------------------------------------------ state
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def distributed_type(self) -> DistributedType:
        return self.state.distributed_type

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

    @property
    def mesh(self):
        """The ("data", "fsdp") `DeviceMesh`, or None with one process and no group."""
        return self.state.mesh

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @property
    def project_dir(self) -> Optional[str]:
        return self.project_configuration.project_dir

    @property
    def logging_dir(self) -> Optional[str]:
        return self.project_configuration.logging_dir

    @property
    def save_iteration(self) -> int:
        """The number the next automatically named checkpoint takes."""
        return self.project_configuration.iteration

    def __repr__(self):
        return repr(self.state._partial) + f"Mixed precision: {self.mixed_precision}\n"

    # ------------------------------------------------------------ accumulation
    def _do_sync(self):
        """Decide whether this step is a sync boundary."""
        if self.gradient_state.sync_with_dataloader and self.gradient_state.end_of_dataloader:
            self.step = 0
            self.gradient_state._set_sync_gradients(True)
        else:
            self.step += 1
            self.gradient_state._set_sync_gradients(self.step % self.gradient_state.num_steps == 0)

    @contextlib.contextmanager
    def accumulate(self, *models):
        """Gradient-accumulation context: the optimizer steps (and clears)
        only at every `gradient_accumulation_steps`-th entry, or at the end
        of the active loader."""
        self._do_sync()
        if self.sync_gradients:
            yield
            return
        # Mid-accumulation: the backward adds to local gradients only.
        with contextlib.ExitStack() as stack:
            for model in models or self._models:
                if isinstance(model, PreparedModel):
                    stack.enter_context(model.no_sync())
            yield

    @contextlib.contextmanager
    def no_sync(self, model=None):
        """Backwards inside add to the local gradients and reduce nothing
        across processes; the optimizer does not step."""
        prev = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            with contextlib.ExitStack() as stack:
                for m in [model] if model is not None else self._models:
                    if isinstance(m, PreparedModel):
                        stack.enter_context(m.no_sync())
                yield
        finally:
            self.gradient_state._set_sync_gradients(prev)

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches=None):
        """Taken for JAX's signature: the prepared loaders give every process
        the same number of batches (`even_batches`), so there are no uneven
        inputs to join; `even_batches` here only warns."""
        if even_batches is not None:
            logger.warning("join_uneven_inputs(even_batches=...) is advisory here; padding is handled by the loader")
        yield

    # ------------------------------------------------------------ processes
    def wait_for_everyone(self):
        """A barrier over every process."""
        self.state.wait_for_everyone()

    def on_main_process(self, function):
        return self.state._partial.on_main_process(function)

    def on_local_main_process(self, function):
        return self.state._partial.on_local_main_process(function)

    def on_process(self, function=None, process_index=None):
        return self.state._partial.on_process(function, process_index)

    @contextlib.contextmanager
    def main_process_first(self):
        with self.state._partial.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self):
        with self.state._partial.local_main_process_first():
            yield

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state._partial.split_between_processes(inputs, apply_padding=apply_padding)

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        """The `nn.Module` under a prepared model (under FSDP, the module
        FSDP placed); `keep_fp32_wrapper` is taken for JAX's signature."""
        return model.module if isinstance(model, PreparedModel) else model

    # ------------------------------------------------------------ prepare
    def prepare(self, *args, device_placement=None):
        """Prepare models, optimizers, loaders and schedulers in one call, in
        any order; optimizers bind to the prepared models, schedulers to the
        prepared optimizers. `device_placement`, one value or one per
        argument, overrides the accelerator's for the loaders."""
        if not isinstance(device_placement, (list, tuple)):
            device_placement = [device_placement] * len(args)
        first = [
            self.prepare_model(obj) if self._is_model(obj)
            else self.prepare_data_loader(obj, device_placement=dp) if self._is_dataloader(obj)
            else obj
            for obj, dp in zip(args, device_placement)
        ]
        second = [self.prepare_optimizer(obj) if self._is_optimizer(obj) else obj for obj in first]
        final = [self.prepare_scheduler(obj) if self._is_scheduler(obj) else obj for obj in second]
        return final[0] if len(final) == 1 else tuple(final)

    @staticmethod
    def _is_model(obj) -> bool:
        return isinstance(obj, (nn.Module, Model, PreparedModel))

    @staticmethod
    def _is_optimizer(obj) -> bool:
        return isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer))

    @staticmethod
    def _is_dataloader(obj) -> bool:
        return isinstance(obj, (SimpleDataLoader, DataLoaderShard, DataLoaderDispatcher, torch.utils.data.DataLoader))

    @classmethod
    def _is_scheduler(cls, obj) -> bool:
        if isinstance(obj, (AcceleratedScheduler, torch.optim.lr_scheduler.LRScheduler)):
            return True
        if cls._is_model(obj) or cls._is_optimizer(obj) or cls._is_dataloader(obj):
            return False
        return callable(obj) and not isinstance(obj, type)

    def prepare_model(self, model, device_placement=None, evaluation_mode: bool = False) -> PreparedModel:
        """Move the model to the device under this accelerator's precision
        mode (and, with ``AutocastKwargs(enabled=False)``, without its
        casts). An `nn.Module` brings its `loss_fn` attribute as the bundled
        loss, if it has one. `device_placement` and `evaluation_mode` are
        taken for JAX's signature."""
        if isinstance(model, PreparedModel):
            if model not in self._models:
                self._models.append(model)
            return model
        if isinstance(model, nn.Module):
            model = Model(model, loss_fn=getattr(model, "loss_fn", None))
        compute_dtype = None if self.mixed_precision == "no" else self.state.compute_dtype
        fp8_recipe = None
        if self.mixed_precision == "fp8":
            fp8_recipe = self.fp8_recipe_handler or FP8RecipeKwargs()
        fsdp = self.state.fsdp_plugin
        # The CompilationConfig policy wins; the plugin's flag is JAX's "full".
        remat_policy = self.compilation_config.remat_policy
        if remat_policy is None and fsdp is not None and fsdp.activation_checkpointing:
            remat_policy = "full"
        autocast = self.autocast_handler is None or self.autocast_handler.enabled
        prepared = PreparedModel(model, self.device, compute_dtype=compute_dtype, remat_policy=remat_policy,
                                 fp8_recipe=fp8_recipe, mesh=self.mesh, fsdp_plugin=fsdp, autocast=autocast)
        self._models.append(prepared)
        return prepared

    def prepare_optimizer(self, optimizer, device_placement=None, model=None) -> AcceleratedOptimizer:
        """Bind a `torch.optim.Optimizer` (built over the model's parameters)
        to the last prepared model."""
        if isinstance(optimizer, AcceleratedOptimizer):
            if optimizer not in self._optimizers:
                self._optimizers.append(optimizer)
            return optimizer
        if model is None:
            if not self._models:
                raise ValueError("Prepare the model before (or together with) the optimizer.")
            model = self._models[-1]
        if getattr(model, "layout", None) is None:
            owned = {id(p) for p in model.parameters()}
            if not any(id(p) in owned for g in optimizer.param_groups for p in g["params"]):
                raise ValueError("the optimizer was built over other parameters than the model's")
        prepared = AcceleratedOptimizer(optimizer, model=model, scaler=self.scaler)
        self._optimizers.append(prepared)
        return prepared

    def prepare_data_loader(self, data_loader, device_placement=None, slice_fn_for_dispatch=None):
        """This process's batches of `data_loader` as tensors, on the device
        unless `device_placement` (default: the accelerator's) is False: its
        share of every global batch across processes, through a sharded
        `DataLoaderShard` or, under ``dataloader_config.dispatch_batches``,
        a `DataLoaderDispatcher`."""
        if isinstance(data_loader, (DataLoaderShard, DataLoaderDispatcher)):
            if data_loader not in self._dataloaders:
                self._dataloaders.append(data_loader)
            return data_loader
        if device_placement is None:
            device_placement = self.device_placement
        cfg = self.dataloader_config
        prepared = prepare_data_loader(
            data_loader, self.device, num_processes=self.num_processes, process_index=self.process_index,
            split_batches=cfg.split_batches or self.split_batches, put_on_device=device_placement,
            rng_types=list(self.rng_types), dispatch_batches=cfg.dispatch_batches, even_batches=cfg.even_batches,
            slice_fn_for_dispatch=slice_fn_for_dispatch, use_seedable_sampler=cfg.use_seedable_sampler)
        self._dataloaders.append(prepared)
        return prepared

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        if isinstance(scheduler, AcceleratedScheduler):
            if scheduler not in self._schedulers:
                self._schedulers.append(scheduler)
            return scheduler
        prepared = AcceleratedScheduler(scheduler, self._optimizers,
                                        step_with_optimizer=self.step_scheduler_with_optimizer,
                                        split_batches=self.dataloader_config.split_batches or self.split_batches)
        self._schedulers.append(prepared)
        if self._last_steps_per_call > 1:
            self._warn_scheduler_coarsened(self._last_steps_per_call)
        return prepared

    def _warn_scheduler_coarsened(self, steps_per_call: int):
        logger.warning(
            "train_step(steps_per_call=%d) with a prepared scheduler: the LR is read once per "
            "call, so the scheduler advances in %d-step strides instead of per optimizer step. "
            "Use steps_per_call=1 for an exact per-step schedule.",
            steps_per_call,
            steps_per_call,
        )

    # ------------------------------------------------------------ backward and steps
    def _resolve_model(self, model) -> PreparedModel:
        if model is not None:
            return model
        if len(self._models) == 1:
            return self._models[0]
        raise ValueError("Multiple prepared models: pass model= to backward()/clip_grad_norm_().")

    def _optimizer_for(self, model: PreparedModel) -> AcceleratedOptimizer:
        for opt in self._optimizers:
            if opt.model is model:
                return opt
        raise ValueError("No prepared optimizer bound to this model.")

    def backward(self, loss_fn: Callable, *args, model: Optional[PreparedModel] = None, **kwargs):
        """Add the gradients of ``loss_fn(*args, **kwargs)``, divided by the
        accumulation count (and under fp16 multiplied by the loss scale),
        into the parameters' ``.grad``; returns the (undivided, unscaled,
        detached) loss, or ``(loss, aux)``. `model` is taken for the JAX
        signature: autograd finds the parameters itself."""
        out = loss_fn(*args, **kwargs)
        loss, aux = out if isinstance(out, tuple) else (out, None)
        if self.scaler is not None and self.scaler.enabled:
            (loss * (self.scaler.scale / self.gradient_state.num_steps)).backward()
        else:
            (loss / self.gradient_state.num_steps).backward()
        loss = loss.detach()
        return (loss, detached(aux)) if aux is not None else loss

    def train_step(
        self,
        loss_fn: Optional[Callable] = None,
        *,
        model: Optional[PreparedModel] = None,
        max_grad_norm: Optional[float] = None,
        accumulation_steps: Optional[int] = None,
        steps_per_call: int = 1,
    ) -> Callable:
        """The fused step `step_fn(batch) -> loss` (see `train_step.py`),
        instrumented (`_instrument_step`) and, under ``analyze=True``,
        guarded. `accumulation_steps` defaults to the accelerator's
        `gradient_accumulation_steps`; pass one batch stacking the
        microbatches along dim 0."""
        model = self._resolve_model(model)
        optimizer = self._optimizer_for(model)
        if accumulation_steps is None:
            accumulation_steps = self.gradient_state.num_steps
        self._last_steps_per_call = steps_per_call
        if steps_per_call > 1 and self._schedulers:
            self._warn_scheduler_coarsened(steps_per_call)
        fused = FusedTrainStep(
            model,
            optimizer,
            loss_fn=loss_fn,
            max_grad_norm=max_grad_norm,
            accumulation_steps=accumulation_steps,
            gradient_state=self.gradient_state,
            steps_per_call=steps_per_call,
            tracer=self.tracer,
        )
        step = fused
        if self.trace_guard is not None:
            # warmup=2, as JAX's: steady-state steps must neither build a
            # kernel nor make an unsanctioned host sync.
            step = self.trace_guard.wrap(step, warmup=2)
        instrumented = self._instrument_step(step)
        # The fused step's model and optimizer ride on the wrapper.
        instrumented.model, instrumented.optimizer = fused.model, fused.optimizer
        return instrumented

    def _instrument_step(self, step_fn: Callable) -> Callable:
        """Telemetry shim around the fused step, as JAX's: each call is timed
        as the timeline's "dispatch" phase (host perf_counter arithmetic, no
        device sync), wrapped in a ``train.step`` span, heartbeats the hang
        watchdog, and polls the ProfilerManager and the flight recorder, so
        touch-file / SIGUSR2 captures and dump requests are served at step
        boundaries. Exceptions (a TraceGuardViolation under analyze=True too)
        propagate untouched."""
        timeline, profiler = self.timeline, self.profiler
        tracer, recorder = self.tracer, self.tracer.recorder
        counter = {"step": 0}

        def instrumented(*args, **kwargs):
            counter["step"] += 1
            with timeline.phase("dispatch"), tracer.span("train.step", category="train", step=counter["step"]):
                out = step_fn(*args, **kwargs)
            timeline.step_done(out)
            recorder.heartbeat()
            profiler.poll()
            recorder.poll()
            return out

        instrumented.__wrapped__ = step_fn  # type: ignore[attr-defined]
        guard = getattr(step_fn, "trace_guard", None)
        if guard is not None:
            instrumented.trace_guard = guard  # type: ignore[attr-defined]
        return instrumented

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0, norm_type: int = 2, model=None):
        """Clip the accumulated gradients by global norm, unscaled first
        under fp16; a no-op (None) while accumulating."""
        if not self.sync_gradients:
            return None
        if norm_type != 2:
            raise NotImplementedError("Only the L2 global norm is supported")
        return self._optimizer_for(self._resolve_model(model)).clip_grad_norm_(max_norm)

    def clip_grad_value_(self, parameters=None, clip_value: float = 1.0, model=None):
        """Clamp the accumulated gradients to [-clip_value, clip_value],
        unscaled first under fp16; a no-op while accumulating."""
        if not self.sync_gradients:
            return
        self._optimizer_for(self._resolve_model(model)).clip_grad_value_(clip_value)

    # ------------------------------------------------------------ triggers
    def set_trigger(self):
        """Raise this process's flag; the next `check_trigger` on every
        process sees it."""
        self.flag_tensor = torch.tensor([1], dtype=torch.int64)

    def check_trigger(self) -> bool:
        """True on every process when any process called `set_trigger` since
        the last check (a sum all-reduce of one int64 across the processes,
        none with one); the flag is then cleared."""
        flag = self.flag_tensor if self.flag_tensor is not None else torch.zeros(1, dtype=torch.int64)
        total = ops.reduce(flag, reduction="sum")
        if int(total[0]) >= 1:
            self.flag_tensor = None
            return True
        return False

    # ------------------------------------------------------------ precision
    @contextlib.contextmanager
    def autocast(self, autocast_handler: Optional[AutocastKwargs] = None):
        """The prepared models' compute-dtype policy for the block
        (`AutocastKwargs().enabled` by default): with ``enabled=False`` a
        bf16 or fp16 model runs in its masters' dtype, without the casts.
        The previous policy is restored on exit. A model FSDP manages can
        not be toggled: FSDP's mixed-precision policy casts its parameters
        at every forward."""
        handler = autocast_handler or AutocastKwargs()
        previous = [(m, m.autocast_enabled) for m in self._models]
        for m in self._models:
            if m.autocast_enabled != handler.enabled and m.compute_dtype is not None:
                if m.layout is not None and m.layout.uses_fsdp:
                    raise NotImplementedError("autocast() cannot toggle a model that FSDP manages: FSDP's "
                                              "mixed-precision policy casts its parameters at every forward")
        try:
            for m in self._models:
                if m.compute_dtype is not None:
                    m.autocast_enabled = handler.enabled
            yield
        finally:
            for m, prev in previous:
                m.autocast_enabled = prev

    # ------------------------------------------------------------ memory
    def free_memory(self, *objects):
        """Forget every prepared object and the step count, and return
        `objects` as as many `None`s (``model, opt = accelerator.free_memory(model, opt)``);
        then collect garbage and, on the card, return the caching
        allocator's free blocks, the memory the next attempt of a
        `find_executable_batch_size` loop needs."""
        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self._last_steps_per_call = 1
        self.step = 0
        objects = [None] * len(objects)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return objects

    def clear(self, *objects):
        """`free_memory`."""
        return self.free_memory(*objects)

    # ------------------------------------------------------------ collectives
    def print(self, *args, **kwargs):
        """`print` on the main process only."""
        self.state._partial.print(*args, **kwargs)

    def gather(self, tensor):
        """The dim-0 concatenation of `tensor` (tensors and arrays through
        dicts, lists and tuples) over the processes, on every process; with
        one process, `tensor` itself."""
        return ops.gather(tensor)

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """`gather` for metrics: on the last batch of a loader whose last
        global batch was topped up (`even_batches`), the repeats are cut off,
        so an evaluation set of N samples gathers N rows. Tensors and arrays
        (through dicts, lists and tuples) are gathered as tensors; other
        data, or any with ``use_gather_object``, as a list of objects."""
        leaves = input_data.values() if isinstance(input_data, dict) else (
            input_data if isinstance(input_data, (list, tuple)) else [input_data])
        as_objects = use_gather_object or not all(isinstance(t, (torch.Tensor, np.ndarray)) for t in leaves)
        if as_objects:
            data = ops.gather_object(input_data if isinstance(input_data, list) else [input_data])
        else:
            data = ops.gather(input_data)
        remainder = self.gradient_state.remainder
        if self.gradient_state.end_of_dataloader and remainder > 0:
            if as_objects:
                return data[:remainder]
            return ops.recursively_apply(lambda t: t[:remainder], data)
        return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        """`tensor` summed (or averaged) over the processes, times `scale`."""
        return ops.reduce(tensor, reduction=reduction, scale=scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
        """`tensor` padded along `dim` to the largest size any process holds."""
        return ops.pad_across_processes(tensor, dim=dim, pad_index=pad_index, pad_first=pad_first)

    # ------------------------------------------------------------ trackers
    def init_trackers(self, project_name: str, config: Optional[dict] = None, init_kwargs: dict = None):
        """Start every tracker of `log_with` under `project_name` and store
        `config` with each."""
        init_kwargs = init_kwargs or {}
        self.trackers = []
        for tracker in self.log_with:
            if isinstance(tracker, GeneralTracker):
                self.trackers.append(tracker)
                continue
            tracker_cls = LOGGER_TYPE_TO_CLASS[str(tracker)]
            kwargs = init_kwargs.get(str(tracker), {})
            if tracker_cls.requires_logging_directory:
                self.trackers.append(tracker_cls(project_name, self.logging_dir, **kwargs))
            else:
                self.trackers.append(tracker_cls(project_name, **kwargs))
        if config is not None:
            for tracker in self.trackers:
                tracker.store_init_configuration(config)

    def get_tracker(self, name: str, unwrap: bool = False):
        for tracker in self.trackers:
            if tracker.name == name:
                return tracker.tracker if unwrap else tracker
        raise ValueError(f"No tracker named {name} is running")

    def log(self, values: dict, step: Optional[int] = None, log_kwargs: dict = None):
        """Log `values` at `step` to every running tracker."""
        log_kwargs = log_kwargs or {}
        for tracker in self.trackers:
            tracker.log(values, step=step, **log_kwargs.get(tracker.name, {}))

    def end_training(self):
        """Finish every tracker, then wait for every process."""
        for tracker in self.trackers:
            tracker.finish()
        self.wait_for_everyone()

    # ------------------------------------------------------------ profiling
    @contextlib.contextmanager
    def profile(self, log_dir: Optional[str] = None):
        """Capture a `torch.profiler` trace (CPU and CUDA) of the wrapped
        block through the `ProfilerManager`; the Chrome trace lands in a
        ``capture_NNN`` directory under `log_dir` (default: the launch's
        profile directory, else ``<logging_dir or project_dir or .>/profile``),
        for Perfetto or chrome://tracing."""
        manager = self.profiler
        if log_dir is not None or not manager.enabled:
            if log_dir is None:
                base = self.logging_dir or self.project_dir or "."
                log_dir = os.path.join(str(base), "profile")
            # A transient manager sharing this Accelerator's registry.
            manager = ProfilerManager(log_dir=str(log_dir), registry=self.telemetry)
        with manager.trace():
            yield

    def save_memory_profile(self, path: str):
        """Dump the CUDA allocator snapshot (`torch.cuda.memory._dump_snapshot`;
        not JAX's pprof) to `path`; raises without CUDA."""
        manager = self.profiler if self.profiler.enabled else ProfilerManager(
            log_dir=os.path.dirname(os.path.abspath(path)) or ".", registry=self.telemetry
        )
        return manager.save_memory_snapshot(path)

    # ------------------------------------------------------------ checkpoints
    def register_for_checkpointing(self, *objects):
        """Save and restore these objects' `state_dict` with the training
        state; an object without `state_dict`/`load_state_dict` raises."""
        invalid = [obj for obj in objects if not (hasattr(obj, "state_dict") and hasattr(obj, "load_state_dict"))]
        if invalid:
            raise ValueError("Objects must expose state_dict/load_state_dict; got invalid: "
                             f"{[type(o).__name__ for o in invalid]}")
        self._custom_objects.extend(objects)

    def register_save_state_pre_hook(self, hook: Callable):
        """`hook(models, weights, output_dir)` runs on every process in
        `save_state`, with the prepared models and, as in JAX, None for
        weights; on the main process before anything is written."""
        self._save_model_hooks.append(hook)

    def register_load_state_pre_hook(self, hook: Callable):
        """`hook(models, input_dir)` runs before `load_state` reads."""
        self._load_model_hooks.append(hook)

    def checkpoint_manager(self) -> CheckpointManager:
        """The run's checkpoint store, ``{project_dir}/checkpoints``, rotating
        to `total_limit`."""
        if self.project_dir is None:
            raise ValueError("checkpoints need ProjectConfiguration(project_dir=...)")
        return CheckpointManager(os.path.join(self.project_dir, "checkpoints"),
                                 keep_last_n=self.project_configuration.total_limit)

    def _run_save_hooks(self, output_dir: str):
        for hook in self._save_model_hooks:
            hook(self._models, None, output_dir)

    def _write_state(self, output_dir: str, state: dict):
        self._run_save_hooks(output_dir)
        checkpointing.write_accelerator_state(output_dir, state)
        for i, obj in enumerate(self._custom_objects):
            checkpointing.save_custom_state(obj, output_dir, i)

    def save_state(self, output_dir: Optional[str] = None) -> str:
        """Save every prepared and registered object. With
        `automatic_checkpoint_naming`, commit ``checkpoint_{save_iteration}``
        through `checkpoint_manager()` (staged, digest manifest, one atomic
        rename, `latest`, rotation); else write into `output_dir` in place,
        each file atomically, and finish with the digest manifest. Returns
        the checkpoint's directory. The save runs in a ``checkpoint.save``
        span, its wall clock is charged to the goodput ledger's
        "checkpoint" cause (failed saves too), and a completed one bumps
        ``checkpoint_saves_total`` and ``checkpoint_save_seconds``."""
        t0 = time.perf_counter()
        try:
            with self.tracer.span("checkpoint.save", category="checkpoint", step=int(self.save_iteration)):
                result = self._save_state_inner(output_dir)
        finally:
            self.timeline.charge("checkpoint", time.perf_counter() - t0)
        self._m_ckpt_saves.inc()
        self._m_ckpt_seconds.observe(time.perf_counter() - t0)
        return result

    def _save_state_inner(self, output_dir: Optional[str]) -> str:
        # Every process takes part in gathering the whole state; the main
        # process writes it while the others wait.
        automatic = self.project_configuration.automatic_checkpoint_naming
        if not automatic and output_dir is None:
            raise ValueError("output_dir is required when automatic_checkpoint_naming is off")
        state = checkpointing.collect_accelerator_state(self._models, self._optimizers, self._schedulers,
                                                        self._dataloaders)
        if automatic:
            manager = self.checkpoint_manager()
            output_dir = os.path.join(manager.base_dir, f"checkpoint_{self.save_iteration}")
            if self.is_main_process:
                output_dir = manager.save(self.save_iteration, lambda d: self._write_state(d, state))
        elif self.is_main_process:
            os.makedirs(output_dir, exist_ok=True)
            self._write_state(output_dir, state)
            checkpointing.write_checkpoint_manifest(output_dir)
        if not self.is_main_process:
            # The main process ran the hooks before it wrote (on the staging
            # directory under automatic naming); the others run them here.
            self._run_save_hooks(output_dir)
        del state
        self.wait_for_everyone()
        self.project_configuration.iteration += 1
        return str(output_dir)

    def load_state(self, input_dir: Optional[str] = None):
        """Restore a checkpoint into the prepared and registered objects.
        `input_dir` is a checkpoint directory (verified against its digest
        manifest), a `CheckpointManager` base directory, or ``"latest"`` /
        None for the newest checkpoint under this run's manager that
        verifies, past a torn newest one. With automatic naming, the next
        save numbers on from the restored checkpoint. The load runs in a
        ``checkpoint.load`` span, its wall clock is charged to the "restart"
        cause, and a completed one bumps ``checkpoint_loads_total``."""
        t0 = time.perf_counter()
        try:
            with self.tracer.span("checkpoint.load", category="checkpoint"):
                result = self._load_state_inner(input_dir)
        finally:
            self.timeline.charge("restart", time.perf_counter() - t0)
        self._m_ckpt_loads.inc()
        return result

    def _load_state_inner(self, input_dir: Optional[str]):
        if input_dir in (None, "latest"):
            input_dir = self.checkpoint_manager().resolve()
        elif CheckpointManager.is_manager_dir(input_dir):
            input_dir = CheckpointManager(input_dir).resolve()
        else:
            input_dir = CheckpointManager(os.path.dirname(str(input_dir)) or ".").resolve(str(input_dir))
        if self.project_configuration.automatic_checkpoint_naming:
            number = re.findall(r"(\d+)(?=[^/]*$)", str(input_dir))
            if number:
                self.project_configuration.iteration = int(number[0]) + 1
        logger.info("Loading states from %s", input_dir)
        for hook in self._load_model_hooks:
            hook(self._models, input_dir)
        checkpointing.load_accelerator_state(input_dir, self._models, self._optimizers, self._schedulers,
                                             self._dataloaders)
        for i, obj in enumerate(self._custom_objects):
            checkpointing.load_custom_state(obj, input_dir, i)
        return input_dir

    def save_model(self, model, save_directory: str, safe_serialization: bool = True, max_shard_size="5GB"):
        """Write just the model's weights (JAX's `save_model`).

        `safe_serialization` (the default) writes safetensors through the
        port's own writer, one file, ``model.safetensors``, under
        `max_shard_size` (``"5GB"``, ``"500MB"``, ``"2GiB"`` or bytes), else
        ``model-0000i-of-0000n.safetensors`` shards with an HF-style
        ``model.safetensors.index.json`` (`checkpointing.save_model_safetensors`);
        without it, ``model.pt``, a `torch.save` of the state dict. Every
        process calls it; across processes each tensor is gathered whole
        in turn and the main process writes (the plugin's FULL_STATE_DICT).
        A SHARDED_STATE_DICT of parameters no process holds whole (FSDP
        over more than one process) waits for ROADMAP A item 5, async and
        sharded checkpoints. As in JAX, a
        non-bool third argument is a shard size (the reference's positional
        order, ``save_model(model, dir, max_shard_size, safe_serialization)``)."""
        if not isinstance(safe_serialization, bool):
            shard_size = safe_serialization
            safe_serialization = max_shard_size if isinstance(max_shard_size, bool) else True
            max_shard_size = shard_size
        os.makedirs(save_directory, exist_ok=True)
        state_dict_type = getattr(self.state.fsdp_plugin, "state_dict_type", None) or "FULL_STATE_DICT"
        layout = getattr(model, "layout", None)
        if state_dict_type == "SHARDED_STATE_DICT" and layout is not None and layout.uses_fsdp and layout.fsdp_size > 1:
            raise NotImplementedError(
                "save_model of a SHARDED_STATE_DICT (each process writing its shards) waits for ROADMAP A "
                "item 5, async and sharded checkpoints; set the plugin's state_dict_type='FULL_STATE_DICT'")
        if not safe_serialization:
            state = model.full_state_dict() if isinstance(model, PreparedModel) else model.state_dict()
            if self.is_main_process:
                checkpointing.atomic_write(os.path.join(save_directory, checkpointing.WEIGHTS_NAME),
                                           lambda f: torch.save(state, f))
            self.wait_for_everyone()
            return
        checkpointing.save_model_safetensors(model, save_directory, max_shard_size=max_shard_size,
                                             is_main=self.is_main_process)
        self.wait_for_everyone()

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        """`dataloader` without its first `num_batches` batches: resume a
        pass where a restored checkpoint left it (`data_loader.skip_first_batches`)."""
        return skip_first_batches(dataloader, num_batches)
