"""The user-facing training facade (the port of the one-process path of
`accelerate_tpu/accelerator.py`).

    accelerator = Accelerator(mixed_precision="bf16")
    model, optimizer, loader, scheduler = accelerator.prepare(model, optimizer, loader, schedule)
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    for batch in loader:
        loss = step_fn(batch)
        scheduler.step()

or the eager surface, as in the JAX package:

    with accelerator.accumulate(model):
        loss = accelerator.backward(model.loss, batch)
        accelerator.clip_grad_norm_(max_norm=1.0)
        optimizer.step()
        optimizer.zero_grad()

The model is an `nn.Module` (or a `modeling.Model` bundle) whose parameters
the optimizer was built over; the optimizer a `torch.optim.Optimizer`; the
loader a `SimpleDataLoader`, a torch `DataLoader` or any iterable of
batches; the scheduler a ``step -> lr`` function or a torch scheduler.
Everything runs on the card unless the caller passes ``cpu=True``.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, List, Optional

import torch
from torch import nn

from .data_loader import DataLoaderShard, SimpleDataLoader, prepare_data_loader
from .modeling import Model, PreparedModel
from .optimizer import AcceleratedOptimizer
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .train_step import FusedTrainStep
from .utils.dataclasses import GradientAccumulationPlugin

logger = logging.getLogger(__name__)


class Accelerator:
    """Owns the device, the precision mode and the prepared objects."""

    def __init__(
        self,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        cpu: bool = False,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
    ):
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu)
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=gradient_accumulation_steps)
        self.gradient_state = GradientState(gradient_accumulation_plugin=gradient_accumulation_plugin)
        self._models: List[PreparedModel] = []
        self._optimizers: List[AcceleratedOptimizer] = []
        self._schedulers: List[AcceleratedScheduler] = []
        self._last_steps_per_call = 1
        self.step = 0

    # ------------------------------------------------------------ state
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

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
        yield

    # ------------------------------------------------------------ prepare
    def prepare(self, *args):
        """Prepare models, optimizers, loaders and schedulers in one call, in
        any order; optimizers bind to the prepared models, schedulers to the
        prepared optimizers."""
        first = [
            self.prepare_model(obj) if self._is_model(obj)
            else self.prepare_data_loader(obj) if self._is_dataloader(obj)
            else obj
            for obj in args
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
        return isinstance(obj, (SimpleDataLoader, DataLoaderShard, torch.utils.data.DataLoader))

    @classmethod
    def _is_scheduler(cls, obj) -> bool:
        if isinstance(obj, (AcceleratedScheduler, torch.optim.lr_scheduler.LRScheduler)):
            return True
        if cls._is_model(obj) or cls._is_optimizer(obj) or cls._is_dataloader(obj):
            return False
        return callable(obj) and not isinstance(obj, type)

    def prepare_model(self, model) -> PreparedModel:
        """Move the model to the device under this accelerator's precision
        mode. An `nn.Module` brings its `loss_fn` attribute as the bundled
        loss, if it has one."""
        if isinstance(model, PreparedModel):
            if model not in self._models:
                self._models.append(model)
            return model
        if isinstance(model, nn.Module):
            model = Model(model, loss_fn=getattr(model, "loss_fn", None))
        compute_dtype = None if self.mixed_precision == "no" else self.state.compute_dtype
        prepared = PreparedModel(model, self.device, compute_dtype=compute_dtype)
        self._models.append(prepared)
        return prepared

    def prepare_optimizer(self, optimizer, model=None) -> AcceleratedOptimizer:
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
        owned = {id(p) for p in model.parameters()}
        if not any(id(p) in owned for g in optimizer.param_groups for p in g["params"]):
            raise ValueError("the optimizer was built over other parameters than the model's")
        prepared = AcceleratedOptimizer(optimizer, model=model)
        self._optimizers.append(prepared)
        return prepared

    def prepare_data_loader(self, data_loader) -> DataLoaderShard:
        """Batches of `data_loader` on the device, as tensors."""
        return prepare_data_loader(data_loader, self.device)

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        if isinstance(scheduler, AcceleratedScheduler):
            if scheduler not in self._schedulers:
                self._schedulers.append(scheduler)
            return scheduler
        prepared = AcceleratedScheduler(scheduler, self._optimizers)
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
        accumulation count, into the parameters' ``.grad``; returns the
        (undivided, detached) loss, or ``(loss, aux)``. `model` is taken for
        the JAX signature: autograd finds the parameters itself."""
        out = loss_fn(*args, **kwargs)
        loss, aux = out if isinstance(out, tuple) else (out, None)
        (loss / self.gradient_state.num_steps).backward()
        loss = loss.detach()
        return (loss, aux) if aux is not None else loss

    def train_step(
        self,
        loss_fn: Optional[Callable] = None,
        *,
        model: Optional[PreparedModel] = None,
        max_grad_norm: Optional[float] = None,
        accumulation_steps: Optional[int] = None,
        steps_per_call: int = 1,
    ) -> FusedTrainStep:
        """The fused step `step_fn(batch) -> loss` (see `train_step.py`).
        `accumulation_steps` defaults to the accelerator's
        `gradient_accumulation_steps`; pass one batch stacking the
        microbatches along dim 0."""
        model = self._resolve_model(model)
        optimizer = self._optimizer_for(model)
        if accumulation_steps is None:
            accumulation_steps = self.gradient_state.num_steps
        self._last_steps_per_call = steps_per_call
        if steps_per_call > 1 and self._schedulers:
            self._warn_scheduler_coarsened(steps_per_call)
        return FusedTrainStep(
            model,
            optimizer,
            loss_fn=loss_fn,
            max_grad_norm=max_grad_norm,
            accumulation_steps=accumulation_steps,
            gradient_state=self.gradient_state,
            steps_per_call=steps_per_call,
        )

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0, norm_type: int = 2, model=None):
        """Clip the accumulated gradients by global norm; a no-op (None)
        while accumulating."""
        if not self.sync_gradients:
            return None
        if norm_type != 2:
            raise NotImplementedError("Only the L2 global norm is supported")
        return self._optimizer_for(self._resolve_model(model)).clip_grad_norm_(max_norm)
