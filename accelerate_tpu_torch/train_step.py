"""The fused training step (the port of `accelerate_tpu/train_step.py`).

`FusedTrainStep` is `step_fn(batch) -> loss`: gradients, optional global-norm
clipping and the optimizer update in one call, the performance path that
`Accelerator.train_step` returns. PyTorch runs eagerly, so "fused" means one
call and no host readback: the returned loss stays on the device, and the
caller decides when to read it.

  - ``accumulation_steps=k > 1``: the batch stacks k microbatches along dim 0
    (``[k*b, ...]``); each microbatch's loss is divided by k before its
    backward, so the gradients add up to those of the mean, and the call
    returns the mean microbatch loss (JAX's `lax.scan` accumulation).
  - ``steps_per_call=K > 1``: the batch stacks K step-batches along dim 0 and
    the call runs K full optimizer steps, returning the last step's loss (the
    learning rate is read once per call, as in JAX's device loop).
  - The learning rate a scheduler installs goes through the optimizer's
    parameter groups, so every step reads the current one.
  - Under fp16 the loss is multiplied by the scaler's scale before its
    backward; the gradients are unscaled, checked and clipped, and a step
    with a non-finite gradient is skipped (JAX's fused fp16 step). That
    check is read on the host once per call, the one readback of an fp16
    step (a sanctioned sync for an armed `TraceGuard`); a skipped step drops
    a ``train.step_skipped`` event (with the new ``loss_scale``) through the
    `tracer`, as JAX's does; ``steps_per_call > 1`` refuses an enabled
    scaler, as in JAX.
  - Every call is a full optimizer step: it marks the sync boundary.
  - Across processes the gradients are averaged once a call (the
    optimizer's `reduce_gradients`, or FSDP's own reduce-scatter in the
    last microbatch's backward): the inner microbatches of an accumulation
    run under the model's `no_sync`. With the FSDP plugin's `reduce_dtype`
    the microbatches' gradients add up in that dtype (FSDP does the same
    for the parameters it manages). The loss each process returns is JAX's
    loss over the global batch, the same number on every process
    (`ops.losses.global_mean`).

JAX's step also drops a ``train.build_program`` event when it builds a jit
program; an eager step builds none, so the port has no such event (its only
compile, a kernel build, is a ``compile`` span of the tracer's build
listener).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch


def split_leading(batch, n: int, what: str):
    """`batch` (a dict, list or tuple of tensors, or a tensor) cut into `n`
    equal parts along dim 0."""
    if isinstance(batch, torch.Tensor):
        if batch.shape[0] % n:
            raise ValueError(f"{what}={n} must divide the batch dim ({batch.shape[0]})")
        return list(batch.chunk(n))
    if isinstance(batch, dict):
        parts = {k: split_leading(v, n, what) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(batch, (list, tuple)):
        parts = [split_leading(v, n, what) for v in batch]
        return [type(batch)(p[i] for p in parts) for i in range(n)]
    raise ValueError(f"{what} > 1 cannot split a batch leaf of type {type(batch).__name__}")


def detached(tree):
    """`tree` (a tensor, or dicts, lists and tuples of them) with every tensor
    detached: a loss function's aux comes back as values, as JAX's do."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(detached(v) for v in tree)
    return tree


class FusedTrainStep:
    """Callable `step_fn(batch) -> loss` running grad + clip + update."""

    def __init__(
        self,
        model,
        optimizer,
        loss_fn: Optional[Callable] = None,
        max_grad_norm: Optional[float] = None,
        accumulation_steps: int = 1,
        gradient_state=None,
        steps_per_call: int = 1,
        tracer=None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn if loss_fn is not None else model.loss
        self.max_grad_norm = max_grad_norm
        self.accumulation_steps = int(accumulation_steps or 1)
        self.steps_per_call = int(steps_per_call or 1)
        if self.steps_per_call > 1 and optimizer.use_scaler:
            raise ValueError(
                "steps_per_call > 1 cannot honor dynamic fp16 loss scaling (scale updates are "
                "per-step host decisions); use bf16 mixed precision or steps_per_call=1"
            )
        self.gradient_state = gradient_state
        # Optional telemetry tracer (Accelerator.train_step passes its own).
        self.tracer = tracer

    def _loss_of(self, *args, **kwargs):
        out = self.loss_fn(*args, **kwargs)
        if isinstance(out, tuple):
            return out
        return out, None

    def _one_step(self, *args, **kwargs):
        accelerated = self.optimizer
        opt = accelerated.optimizer
        opt.zero_grad(set_to_none=True)
        k = self.accumulation_steps
        loss_scale = accelerated.scaler.scale if accelerated.use_scaler else 1.0
        aux = None
        if k > 1:
            if len(args) != 1 or kwargs:
                raise ValueError("accumulation_steps > 1 takes exactly one positional batch")
            losses = []
            no_sync = getattr(self.model, "no_sync", contextlib.nullcontext)
            layout = getattr(self.model, "layout", None)
            reduce_dtype = getattr(self.model, "reduce_dtype", None)
            sums = {} if reduce_dtype is not None and layout is not None and not layout.uses_fsdp else None
            for i, mbatch in enumerate(split_leading(args[0], k, "accumulation_steps")):
                with no_sync() if i < k - 1 else contextlib.nullcontext():
                    loss, _ = self._loss_of(mbatch)
                    (loss * (loss_scale / k) if loss_scale != 1.0 else loss / k).backward()
                losses.append(loss.detach())
                if sums is not None:
                    for param in layout.orig.values():
                        if param.grad is not None:
                            grad = param.grad.to(reduce_dtype)
                            sums[param] = grad if param not in sums else sums[param] + grad
                            param.grad = None
            if sums:
                for param, grad in sums.items():
                    param.grad = grad.to(param.dtype)
            loss = torch.stack(losses).mean()
        else:
            loss, aux = self._loss_of(*args, **kwargs)
            (loss * loss_scale if loss_scale != 1.0 else loss).backward()
            loss, aux = loss.detach(), detached(aux)
        accelerated.unscale_()
        if self.max_grad_norm is not None:
            accelerated.clip_grad_norm_(self.max_grad_norm)
        if accelerated.apply_or_skip() and self.tracer is not None:
            self.tracer.event("train.step_skipped", category="train", loss_scale=float(accelerated.scaler.scale))
        opt.zero_grad(set_to_none=True)
        return loss, aux

    def __call__(self, *args, **kwargs):
        if self.steps_per_call > 1:
            if len(args) != 1 or kwargs:
                raise ValueError("steps_per_call > 1 takes exactly one positional batch")
            for sbatch in split_leading(args[0], self.steps_per_call, "steps_per_call"):
                loss, aux = self._one_step(sbatch)
                if aux is not None:
                    raise ValueError(
                        "steps_per_call > 1 does not support loss functions that return "
                        "(loss, aux); use steps_per_call=1 for aux outputs"
                    )
        else:
            loss, aux = self._one_step(*args, **kwargs)
        if self.gradient_state is not None:
            self.gradient_state._set_sync_gradients(True)
        if aux is not None:
            return loss, aux
        return loss
