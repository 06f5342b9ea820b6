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
`skip_first_batches(loader, steps_done_in_the_pass)`. As in JAX,
``async_save=True`` (or ``ACCELERATE_TPU_ASYNC_SAVE=1``, `launch
--async_save`) makes a save block only for the copy of the state to host
memory and the wait for the previous commit, the files being written by a
background committer (`drain_checkpoints`, `poll_async_checkpoint`,
`abort_async_checkpoint`); ``sharded_save=True`` (``--sharded_save``) has
each process write its own shards under ``host_*/``;
``save_interval=N`` or ``"auto"`` (against ``lost_checkpoint_s``) drives
`maybe_save_state` at each step boundary; and
`register_preemption_checkpoint` with `check_preemption` saves and exits
143 on a SIGTERM.

or the eager surface, as in the JAX package:

    with accelerator.accumulate(model):
        loss = accelerator.backward(model.loss, batch)
        accelerator.clip_grad_norm_(max_norm=1.0)
        optimizer.step()
        optimizer.zero_grad()

Activation checkpointing: ``Accelerator(compilation_config=CompilationConfig(
remat_policy="full"))`` checkpoints every in-tree layer (`ops/remat.py`).
fp8: ``Accelerator(mixed_precision="fp8", kwargs_handlers=[FP8RecipeKwargs(...)])``
runs every linear layer's product in fp8 (`ops/fp8.py`), the rest in bf16;
across processes each product is scaled by the global batch's amax.
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

Past the card: the plugin's `offload_optimizer_state`, `cpu_offload` and
``offload_optimizer_device="disk"`` (or ``deepspeed_plugin=DeepSpeedPlugin(
hf_ds_config=...)``, lowered as JAX lowers it; ``megatron_lm_plugin=`` lowers
to the mesh) keep the optimizer's state, and the masters, off the card
between steps (`optimizer.py`, `modeling.py`).

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
from .ops.losses import batch_group
from .optimizer import AcceleratedOptimizer, GradScaler
from .parallel.mesh import data_parallel_group, mesh_sizes
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
    DeepSpeedPlugin,
    DistributedDataParallelKwargs,
    DistributedType,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    KwargsHandler,
    MegatronLMPlugin,
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
        deepspeed_plugin: Optional[DeepSpeedPlugin] = None,
        megatron_lm_plugin: Optional[MegatronLMPlugin] = None,
        compilation_config: Optional[CompilationConfig] = None,
        rng_types: Optional[List[str]] = None,
        kwargs_handlers: Optional[List[KwargsHandler]] = None,
        step_scheduler_with_optimizer: bool = True,
        analyze: bool = False,
        tracer=None,
        async_save: Optional[bool] = None,
        sharded_save: Optional[bool] = None,
        save_interval=None,
        lost_checkpoint_s: float = 300.0,
    ):
        # analyze=True: every train_step() is wrapped in a TraceGuard that,
        # after a warmup allowance, raises when a steady-state step builds a
        # kernel or makes an unsanctioned host sync.
        self.analyze = bool(analyze)
        self.trace_guard = None
        if self.analyze:
            from .analysis.trace_guard import TraceGuard

            self.trace_guard = TraceGuard(name="train-step", on_violation="raise")
        # Asynchronous and sharded saves (the launcher's variables by
        # default); `save_interval` ("auto" or a number of steps) arms
        # `maybe_save_state`.
        if async_save is None:
            async_save = parse_flag_from_env("ACCELERATE_TPU_ASYNC_SAVE")
        if sharded_save is None:
            sharded_save = parse_flag_from_env("ACCELERATE_TPU_SHARDED_SAVE")
        self.async_save = bool(async_save)
        self.sharded_save = bool(sharded_save)
        self._async_committer: Optional[checkpointing.AsyncCommitter] = None
        self._checkpoint_managers = {}
        self._host_staging: Optional[checkpointing.HostStaging] = None
        self.save_controller: Optional[checkpointing.AdaptiveSaveInterval] = None
        if save_interval == "auto":
            self.save_controller = checkpointing.AdaptiveSaveInterval(lost_checkpoint_s=lost_checkpoint_s)
        elif save_interval is not None:
            self.save_controller = checkpointing.AdaptiveSaveInterval(lost_checkpoint_s=lost_checkpoint_s,
                                                                      fixed_interval=int(save_interval))
        self._steps_since_save = 0
        self._last_step_boundary: Optional[float] = None
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
                                      parallelism_config=parallelism_config, fsdp_plugin=fsdp_plugin,
                                      deepspeed_plugin=deepspeed_plugin, megatron_lm_plugin=megatron_lm_plugin,
                                      **init_kwargs)
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
            # The launcher's variable wins over the argument, as in JAX.
            gas = int(os.environ.get("ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS", gradient_accumulation_steps))
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=gas)
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
        self._m_ckpt_commit_seconds = self.telemetry.histogram(
            "checkpoint_async_commit_seconds",
            help="background (async) checkpoint commit wall-clock, overlapped with training and not charged "
                 "to the goodput ledger")
        self._g_ckpt_in_flight = self.telemetry.gauge(
            "checkpoint_commits_in_flight", help="async checkpoint commits currently running")

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
        """The ("data", "fsdp"[, "model"]) `DeviceMesh`, or None with one process and no group."""
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
            model = Model(model, loss_fn=getattr(model, "loss_fn", None),
                          sharding_rules=getattr(model, "sharding_rules", None))
        if isinstance(model.sharding_rules, str):
            self._plan_sharding(model)
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
                                 fp8_recipe=fp8_recipe, mesh=self.mesh, fsdp_plugin=fsdp, autocast=autocast,
                                 offload_params=bool(getattr(fsdp, "offload_params", False)))
        self._models.append(prepared)
        return prepared

    def _plan_sharding(self, model: Model):
        """``sharding_rules="auto"``: the cost-model planner searches the
        "model" layout for this mesh and, on a mesh with a "data" axis, the
        ZeRO optimizer-state table (moments over "data" even where the
        parameters replicate), as JAX's `prepare_model` does; the resolved
        table replaces the sentinel on the bundle and the opt table goes
        beside it, so the optimizer's placement reads the same tables. The
        workload is JAX's: batch 8, seq 512, f32 Adam moments (8 bytes a
        parameter), on this accelerator's chip."""
        from .parallel.planner import Workload, default_chip, resolve_sharding_rules

        if model.sharding_rules == "rules":
            raise ValueError(
                "sharding_rules='rules' is a serving-engine sentinel (it "
                "means 'fall back to the Model bundle's family table'); on "
                "this seam the bundle's sharding_rules IS that table, and "
                "the sentinel just overwrote it — leave the table in place, "
                "or pass 'auto' for the planner"
            )
        # (A "pipeline" axis, JAX's MPMD route, is refused by the mesh itself,
        # naming the pipelines bullet.)
        sizes = mesh_sizes(self.mesh) if self.mesh is not None else {"model": 1}
        plan_axes = tuple(a for a in ("data", "model") if sizes.get(a, 1) > 1) or ("model",)
        rules, plan = resolve_sharding_rules(
            model.sharding_rules, model.module, sizes,
            plan_kwargs=dict(axes=plan_axes, chip=default_chip(self.device),
                             workload=Workload(batch=8, seq=512, opt_bytes_per_param=8.0)))
        model.sharding_rules = rules
        if plan is not None and plan.opt_rules:
            model.opt_sharding_rules = list(plan.opt_rules)

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
        prepared = AcceleratedOptimizer(optimizer, model=model, scaler=self.scaler, fsdp_plugin=self.state.fsdp_plugin)
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
        # Over a "model" axis the ranks of one data shard take the same batches.
        model = 1 if self.mesh is None else mesh_sizes(self.mesh)["model"]
        prepared = prepare_data_loader(
            data_loader, self.device, num_processes=self.num_processes // model,
            process_index=self.process_index // model,
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
        with batch_group(data_parallel_group(self.mesh)):
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
        one process, `tensor` itself. Under a "model" axis above 1 the ranks
        of one data shard hold the same rows, which JAX's one controller
        holds once: it gathers over this process's "data" ranks only, so
        each row comes back once."""
        return ops.gather(tensor, group=data_parallel_group(self.mesh))

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
            data = ops.gather_object(input_data if isinstance(input_data, list) else [input_data],
                                     group=data_parallel_group(self.mesh))
        else:
            data = self.gather(input_data)
        remainder = self.gradient_state.remainder
        if self.gradient_state.end_of_dataloader and remainder > 0:
            if as_objects:
                return data[:remainder]
            return ops.recursively_apply(lambda t: t[:remainder], data)
        return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        """`tensor` summed (or averaged) over the processes, times `scale`;
        over the "data" ranks only under a "model" axis, as `gather`."""
        return ops.reduce(tensor, reduction=reduction, scale=scale, group=data_parallel_group(self.mesh))

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
        """`tensor` padded along `dim` to the largest size any process (any
        "data" rank under a "model" axis, as `gather`) holds."""
        return ops.pad_across_processes(tensor, dim=dim, pad_index=pad_index, pad_first=pad_first,
                                        group=data_parallel_group(self.mesh))

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
        """Wait for the last asynchronous commit (its failure raises), finish
        every tracker, then wait for every process."""
        self.drain_checkpoints()
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

    def checkpoint_manager(self, base_dir: Optional[str] = None) -> CheckpointManager:
        """The run's checkpoint store, ``{project_dir}/checkpoints`` (or
        `base_dir`), rotating to `total_limit`. One manager per (base
        directory, limit): its record of the saves in flight is what keeps
        `next_step` and a background commit from taking one step twice."""
        if base_dir is None:
            if self.project_dir is None:
                raise ValueError("checkpoints need ProjectConfiguration(project_dir=...)")
            base_dir = os.path.join(self.project_dir, "checkpoints")
        key = (str(base_dir), self.project_configuration.total_limit)
        if key not in self._checkpoint_managers:
            self._checkpoint_managers[key] = CheckpointManager(key[0], keep_last_n=key[1])
        return self._checkpoint_managers[key]

    def _run_save_hooks(self, output_dir: str):
        for hook in self._save_model_hooks:
            hook(self._models, None, output_dir)

    def _write_state(self, output_dir: str, state: dict):
        self._run_save_hooks(output_dir)
        checkpointing.write_accelerator_state(output_dir, state)
        for i, obj in enumerate(self._custom_objects):
            checkpointing.save_custom_state(obj, output_dir, i)

    def maybe_save_state(self, output_dir: Optional[str] = None, **save_kwargs) -> Optional[str]:
        """The `save_interval` cadence at a step boundary (JAX's): call once a step. It
        times the step since the last call, asks the controller whether a
        save is due and, when it is, runs `save_state(output_dir,
        **save_kwargs)` and feeds the controller the seconds the goodput
        ledger charged it (an asynchronous save's blocking seconds only).
        Returns the checkpoint's path when it saved, else None."""
        if self.save_controller is None:
            raise RuntimeError("maybe_save_state() needs a cadence: construct the Accelerator with "
                               'save_interval="auto" (goodput-driven) or save_interval=<steps>')
        now = time.perf_counter()
        if self._last_step_boundary is not None:
            self.save_controller.observe_step(now - self._last_step_boundary)
        self._last_step_boundary = now
        self._steps_since_save += 1
        if not self.save_controller.should_save(self._steps_since_save):
            return None
        charged_before = self.timeline.goodput()["lost_s"].get("checkpoint", 0.0)
        t0 = time.perf_counter()
        path = self.save_state(output_dir, **save_kwargs)
        blocked = time.perf_counter() - t0
        charged = self.timeline.goodput()["lost_s"].get("checkpoint", 0.0) - charged_before
        self.save_controller.observe_save(charged if charged > 0 else blocked)
        self._steps_since_save = 0
        self._last_step_boundary = time.perf_counter()  # a save's time is not a step's
        return path

    def save_state(self, output_dir: Optional[str] = None, async_save: Optional[bool] = None,
                   sharded: Optional[bool] = None, **save_model_kwargs) -> str:
        """Save every prepared and registered object. With
        `automatic_checkpoint_naming`, commit ``checkpoint_{save_iteration}``
        through `checkpoint_manager()` (staged, digest manifest, one atomic
        rename, `latest`, rotation); else write into `output_dir` in place,
        each file atomically, and finish with the digest manifest. Returns
        the checkpoint's directory. The save runs in a ``checkpoint.save``
        span, its wall clock is charged to the goodput ledger's
        "checkpoint" cause (failed saves too), and a completed one bumps
        ``checkpoint_saves_total`` and ``checkpoint_save_seconds``.

        `async_save` and `sharded` override the accelerator's settings for
        this call. A sharded save has each process write its own shards
        under ``host_*/``. An asynchronous one blocks only for the wait on
        the previous commit and the copy of the state to host memory, and
        only that is charged; a background thread writes and publishes it
        in a ``checkpoint.commit`` span, timed by
        ``checkpoint_async_commit_seconds``; a failed commit raises
        `CheckpointCommitError` at the next save or `drain_checkpoints()`.
        The path returned is where it will publish: drain before reading
        it. Across processes an asynchronous save must be sharded (the
        committer may run no collective). `save_model_kwargs` are accepted
        for JAX's signature and unused, as there."""
        async_save = self.async_save if async_save is None else bool(async_save)
        sharded = self.sharded_save if sharded is None else bool(sharded)
        if async_save:
            return self._save_state_async(output_dir, sharded)
        t0 = time.perf_counter()
        try:
            with self.tracer.span("checkpoint.save", category="checkpoint", step=int(self.save_iteration)):
                result = self._save_state_inner(output_dir, sharded)
        finally:
            self.timeline.charge("checkpoint", time.perf_counter() - t0)
        self._m_ckpt_saves.inc()
        self._m_ckpt_seconds.observe(time.perf_counter() - t0)
        return result

    def _sharded_manifest(self, sharded: bool):
        return checkpointing.sharded_manifest_extra(self.num_processes) if sharded else None

    def _save_managed(self, manager: CheckpointManager, step: int, sharded: bool) -> str:
        """One synchronous save into `manager` as ``checkpoint_{step}``, on
        every process."""
        if sharded:
            snapshot = self._snapshot(sharded=True)
            return manager.save(step, lambda d: self._commit_snapshot(d, snapshot), is_main=self.is_main_process,
                                barrier=self.wait_for_everyone, manifest_extra=self._sharded_manifest(True))
        # Every process takes part in gathering the whole state; the main
        # process writes it while the others wait.
        state = checkpointing.collect_accelerator_state(self._models, self._optimizers, self._schedulers,
                                                        self._dataloaders)
        output_dir = os.path.join(manager.base_dir, f"checkpoint_{step}")
        if self.is_main_process:
            output_dir = manager.save(step, lambda d: self._write_state(d, state))
        else:
            # The main process ran the hooks before it wrote (on the staging
            # directory); the others run them here.
            self._run_save_hooks(output_dir)
        del state
        self.wait_for_everyone()
        return output_dir

    def _save_state_inner(self, output_dir: Optional[str], sharded: bool = False) -> str:
        automatic = self.project_configuration.automatic_checkpoint_naming
        if not automatic and output_dir is None:
            raise ValueError("output_dir is required when automatic_checkpoint_naming is off")
        if automatic:
            output_dir = self._save_managed(self.checkpoint_manager(), self.save_iteration, sharded)
        elif sharded:
            snapshot = self._snapshot(sharded=True)
            self.wait_for_everyone()
            os.makedirs(output_dir, exist_ok=True)
            self._commit_snapshot(output_dir, snapshot)
            self.wait_for_everyone()  # every process's shards land before the digest scan
            if self.is_main_process:
                checkpointing.write_checkpoint_manifest(output_dir, extra=self._sharded_manifest(True))
            self.wait_for_everyone()
        else:
            state = checkpointing.collect_accelerator_state(self._models, self._optimizers, self._schedulers,
                                                            self._dataloaders)
            if self.is_main_process:
                os.makedirs(output_dir, exist_ok=True)
                self._write_state(output_dir, state)
                checkpointing.write_checkpoint_manifest(output_dir)
            else:
                self._run_save_hooks(output_dir)
            del state
            self.wait_for_everyone()
        self.project_configuration.iteration += 1
        return str(output_dir)

    # ------------------------------------------------------------ async checkpoints
    def _committer(self) -> checkpointing.AsyncCommitter:
        if self._async_committer is None:
            self._async_committer = checkpointing.AsyncCommitter()
        return self._async_committer

    def _snapshot(self, sharded: bool, staging: Optional[checkpointing.HostStaging] = None) -> dict:
        return checkpointing.snapshot_accelerator_state(
            self._models, self._optimizers, self._schedulers, self._dataloaders, sharded=sharded,
            custom_objects=tuple(self._custom_objects), staging=staging)

    def _commit_snapshot(self, output_dir: str, snapshot: dict, abort=None):
        """Write a snapshot: the save hooks (on the committer thread for an
        asynchronous save, against the live objects), then its files."""
        self._run_save_hooks(output_dir)
        checkpointing.write_accelerator_snapshot(snapshot, output_dir, process_index=self.process_index,
                                                 num_processes=self.num_processes, is_main=self.is_main_process,
                                                 abort=abort)

    def _save_state_async(self, output_dir: Optional[str], sharded: bool) -> str:
        """Snapshot, then commit in the background (JAX's): the caller pays
        for the wait on the previous commit and the copy of the state into
        the kept host buffers (`HostStaging`); only that is charged to the
        goodput ledger."""
        if self.num_processes > 1 and not sharded:
            raise ValueError(
                "async_save with num_processes > 1 requires sharded=True: the background committer cannot run "
                "collective barriers, so cross-host commits coordinate through the per-host shard sentinels")
        t0 = time.perf_counter()
        committer = self._committer()
        step = int(self.save_iteration)
        try:
            with self.tracer.span("checkpoint.save", category="checkpoint", step=step, mode="async"):
                # The previous commit finishes before this one snapshots (one
                # commit in flight bounds the host memory), and its failure
                # raises here.
                committer.wait()
                if self._save_model_hooks:
                    logger.warning("async_save runs registered save-state hooks on the committer thread against "
                                   "live objects; use synchronous saves if a hook reads state that training mutates")
                if self._host_staging is None:
                    self._host_staging = checkpointing.HostStaging()
                snapshot = self._snapshot(sharded, staging=self._host_staging)
                extra = self._sharded_manifest(sharded)
                if self.project_configuration.automatic_checkpoint_naming:
                    manager = self.checkpoint_manager()
                    final = os.path.join(manager.base_dir, f"checkpoint_{step}")

                    def writer(abort):
                        manager.save(step, lambda staging: self._commit_snapshot(staging, snapshot, abort),
                                     is_main=self.is_main_process, abort=abort, manifest_extra=extra)
                else:
                    if output_dir is None:
                        raise ValueError("output_dir is required when automatic_checkpoint_naming is off")
                    final = str(output_dir)

                    def writer(abort):
                        os.makedirs(final, exist_ok=True)
                        self._commit_snapshot(final, snapshot, abort)
                        if self.is_main_process:
                            checkpointing.write_checkpoint_manifest(final, extra=extra)

                self.project_configuration.iteration += 1
        finally:
            blocking = time.perf_counter() - t0
            self.timeline.charge("checkpoint", blocking)
        self._m_ckpt_seconds.observe(blocking)
        logger.info("Async save of step %d accepted; committing to %s in background", step, final)

        def timed_commit(abort):
            c0 = time.perf_counter()
            try:
                with self.tracer.span("checkpoint.commit", category="checkpoint", step=step, mode="async"):
                    writer(abort)
            finally:
                self._g_ckpt_in_flight.set(0)
                self._m_ckpt_commit_seconds.observe(time.perf_counter() - c0)
            self._m_ckpt_saves.inc()  # completions only, as the synchronous path

        # In flight from the submit: the gauge reads 1 as soon as this returns.
        self._g_ckpt_in_flight.set(1)
        try:
            committer.submit(timed_commit, label=f"checkpoint_{step}")
        except BaseException:
            self._g_ckpt_in_flight.set(0)
            raise
        return final

    def drain_checkpoints(self, timeout: Optional[float] = None):
        """Wait for the asynchronous commit in flight; its failure raises
        `CheckpointCommitError`. Call before reading a checkpoint just
        saved, at the end of training, before a preemption's save."""
        if self._async_committer is not None:
            self._async_committer.drain(timeout)

    def poll_async_checkpoint(self):
        """Without blocking, raise a commit's process-death failure (a kill,
        a KeyboardInterrupt); an ordinary failure waits for the next save or
        drain. Call at step boundaries."""
        if self._async_committer is not None:
            self._async_committer.poll()

    def abort_async_checkpoint(self, timeout: float = 30.0):
        """Hard shutdown: abort the commit in flight (it will not publish)
        and join it without raising; returns what it failed with, if
        anything. The next asynchronous save builds a fresh committer."""
        committer, self._async_committer = self._async_committer, None
        if committer is None:
            return None
        return committer.abort_and_join(timeout)

    # ------------------------------------------------------------ preemption
    def register_preemption_checkpoint(self, output_dir: Optional[str] = None, exit_on_save: bool = True):
        """Latch SIGTERM (`fault_tolerance.PreemptionHandler`); then
        `check_preemption()` saves at the next step boundary. `output_dir` is
        a `CheckpointManager` base: each preemption save commits an atomically
        published ``checkpoint_N`` in it (the last 2 kept), so a kill racing
        the save never leaves a torn checkpoint, and `load_state(output_dir)`
        resumes from the newest that verifies. Off the main thread the latch
        warns and does nothing. Returns the handler."""
        from .fault_tolerance import PreemptionHandler

        self._preemption_handler = PreemptionHandler()
        self._preemption_dir = output_dir
        self._preemption_exit = exit_on_save
        return self._preemption_handler

    @property
    def preemption_requested(self) -> bool:
        handler = getattr(self, "_preemption_handler", None)
        return handler is not None and handler.preemption_requested

    def check_preemption(self) -> bool:
        """At a step boundary: without a latched SIGTERM, False. With one,
        wait for the asynchronous commit in flight (its failure is logged:
        the preemption's save supersedes it), save synchronously (into the
        registered base, else as `save_state` would), and raise
        ``SystemExit(143)``, or return True under ``exit_on_save=False``."""
        if not self.preemption_requested:
            return False
        from .fault_tolerance import PREEMPTED_EXIT_CODE

        try:
            self.drain_checkpoints()
        except checkpointing.CheckpointCommitError as exc:
            logger.warning("in-flight async checkpoint commit failed during preemption flush (%s); the preemption "
                           "checkpoint will supersede it", exc)
        preemption_dir = getattr(self, "_preemption_dir", None)
        if preemption_dir is not None and not self.project_configuration.automatic_checkpoint_naming:
            manager = CheckpointManager(preemption_dir, keep_last_n=2)
            path = self._save_managed(manager, manager.next_step(), self.sharded_save)
        else:
            # Always synchronous: the process exits right after this save.
            path = self.save_state(preemption_dir, async_save=False)
        self.print(f"preemption checkpoint saved to {path}")
        if getattr(self, "_preemption_exit", True):
            raise SystemExit(PREEMPTED_EXIT_CODE)
        return True

    def load_state(self, input_dir: Optional[str] = None):
        """Restore a checkpoint into the prepared and registered objects.
        `input_dir` is a checkpoint directory (verified against its digest
        manifest), a `CheckpointManager` base directory, or ``"latest"`` /
        None for the newest checkpoint under this run's manager that
        verifies, past a torn newest one. A sharded checkpoint (``host_*/``)
        is gathered and taken under the current layout, whatever wrote it.
        With automatic naming, the next save numbers on from the restored
        checkpoint. An asynchronous commit in flight lands first (its
        failure is logged and passed over). The load runs in a
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
        try:
            self.drain_checkpoints()
        except checkpointing.CheckpointCommitError as exc:
            logger.warning("async commit failed before load_state (%s); resolving past it", exc)
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
        load = (checkpointing.load_sharded_accelerator_state if checkpointing.is_sharded_checkpoint_dir(input_dir)
                else checkpointing.load_accelerator_state)
        load(input_dir, self._models, self._optimizers, self._schedulers, self._dataloaders)
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
        over more than one process) raises: JAX writes it in orbax's
        layout, which the port does not write (ROADMAP A item 1);
        `save_state(sharded=True)` writes each process's shards. As in JAX, a
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
                "save_model of a SHARDED_STATE_DICT (each process writing its shards) waits for ROADMAP A item 1: "
                "JAX writes it in orbax's layout, which the port does not write yet; set the plugin's "
                "state_dict_type='FULL_STATE_DICT', or save_state(sharded=True) for each process's shards")
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
