"""The accelerated optimizer (the port of `accelerate_tpu/optimizer.py`'s
`AcceleratedOptimizer`, its clipping rule and fp16's `GradScaler`).

It wraps a `torch.optim.Optimizer` built over the module's parameters.
Gradients accumulate in the parameters' ``.grad`` as autograd leaves them;
`step` applies the update only at a sync boundary and `zero_grad` clears
only there, so microbatches in between keep adding up (the JAX package's
eager contract). The learning rate a scheduler installs
(`set_learning_rate`) is written into every parameter group at once, so the
eager and the fused step read the same value.

Under ``mixed_precision="fp16"`` the optimizer holds the accelerator's
`GradScaler`: the backward multiplied the loss by its scale, so the
gradients are divided by it once (before clipping, as JAX's
`unscale_and_clip`), checked for non-finite values, and a step with any
is skipped: the parameters and the optimizer's state stay exactly as they
were, `step_was_skipped` is set and the scale backs off.

Across processes (a prepared model with a `parallel.fsdp.ShardedLayout`)
the optimizer is pointed at the tensors the layout updates (the shards of
a sharded strategy), so its state is sharded like them. Once a step, before
the gradients are unscaled, clipped or applied, they are averaged over the
processes (`reduce_gradients`); the clipping norm is the global one over
the shards, the non-finite check is taken over every process (a max), so
every process skips the same steps, and `state_dict` / `load_state_dict`
carry the whole state, gathered and cut again.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from .analysis.trace_guard import allow_sync
from .state import GradientState
from .utils.dataclasses import GradScalerKwargs


class GradScaler:
    """Dynamic loss scaling for fp16, on the host (JAX's `GradScaler`): the
    scale halves (`backoff_factor`) after a step with non-finite gradients
    and doubles (`growth_factor`) after `growth_interval` finite steps in a
    row."""

    def __init__(self, kwargs: Optional[GradScalerKwargs] = None):
        kwargs = kwargs or GradScalerKwargs()
        self.scale = float(kwargs.init_scale)
        self.growth_factor = kwargs.growth_factor
        self.backoff_factor = kwargs.backoff_factor
        self.growth_interval = kwargs.growth_interval
        self.enabled = kwargs.enabled
        self._growth_tracker = 0

    def update(self, found_inf: bool):
        if not self.enabled:
            return
        if found_inf:
            self.scale *= self.backoff_factor
            self._growth_tracker = 0
        else:
            self._growth_tracker += 1
            if self._growth_tracker >= self.growth_interval:
                self.scale *= self.growth_factor
                self._growth_tracker = 0

    def state_dict(self):
        return {"scale": self.scale, "growth_tracker": self._growth_tracker}

    def load_state_dict(self, state):
        self.scale = state["scale"]
        self._growth_tracker = state["growth_tracker"]


def unscale_grads(grads: List[torch.Tensor], inv_scale: float) -> torch.Tensor:
    """Multiply every gradient by `inv_scale` in place; returns a 1-element
    f32 tensor, 1 where any gradient held a non-finite value (JAX's
    unscale and `isfinite` check, in one pass over the gradients)."""
    found_inf = torch.zeros(1, dtype=torch.float32, device=grads[0].device)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found_inf, torch.full((1,), inv_scale, dtype=torch.float32, device=grads[0].device)
    )
    return found_inf


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def clip_grad_norm(parameters: Iterable[torch.nn.Parameter], max_norm: float, layout=None) -> torch.Tensor:
    """Scale the gradients by ``min(1, max_norm / (norm + 1e-6))``, the norm
    being the global L2 norm over every gradient in fp32 (JAX's
    `unscale_and_clip`); returns the pre-clip norm as a 0-d tensor. With a
    `layout` the norm runs over the whole gradients, shards summed across
    the processes (`ShardedLayout.grad_norm`)."""
    parameters = list(parameters)
    grads = [_local(p.grad) for p in parameters if p.grad is not None]
    if layout is not None:
        norm = layout.grad_norm(parameters)
    else:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm


class AcceleratedOptimizer:
    """A `torch.optim.Optimizer` bound to a prepared model, with the
    accelerator's `GradScaler` under fp16."""

    def __init__(self, optimizer: torch.optim.Optimizer, model=None, scaler: Optional[GradScaler] = None):
        self.optimizer = optimizer
        self.model = model
        self.layout = getattr(model, "layout", None)
        if self.layout is not None:
            self.layout.adopt(optimizer)
        self.scaler = scaler
        self.gradient_state = GradientState()
        self.step_was_skipped = False
        self._found_inf: Optional[torch.Tensor] = None  # set once the gradients are unscaled
        self._reduced = False  # the gradients of this step were averaged over the processes

    def _params(self):
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def _grads(self):
        """This process's gradients (a sharded one's local shard)."""
        return [_local(p.grad) for p in self._params() if p.grad is not None]

    def _mixed_update(self):
        """Under FSDP the optimizer holds `DTensor`s beside the plain
        parameters FSDP ignores; torch's foreach and fused updates take one
        list of both only with the plain ones read as replicated."""
        if self.layout is not None and self.layout.uses_fsdp:
            return implicit_replication()
        return contextlib.nullcontext()

    def reduce_gradients(self):
        """Average this step's gradients over the processes, once."""
        if self.layout is not None and not self._reduced:
            self.layout.reduce_gradients()
        self._reduced = True

    @property
    def use_scaler(self) -> bool:
        return self.scaler is not None and self.scaler.enabled

    def unscale_(self) -> Optional[torch.Tensor]:
        """Divide the accumulated gradients by the loss scale, once per step
        (JAX's unscale-once contract); returns the non-finite flag, or None
        without an enabled scaler."""
        self.reduce_gradients()
        if not self.use_scaler:
            return None
        if self._found_inf is None:
            found_inf = unscale_grads(self._grads(), 1.0 / self.scaler.scale)
            if self.layout is not None and dist.get_world_size() > 1:
                # One process's overflow skips the step everywhere.
                dist.all_reduce(found_inf, op=dist.ReduceOp.MAX)
            self._found_inf = found_inf
        return self._found_inf

    def apply_or_skip(self) -> bool:
        """The update from unscaled gradients, or, under an enabled scaler
        whose check found a non-finite gradient, no update at all; the
        scaler learns which (one host readback of the flag). Returns True
        when the step was skipped."""
        skipped = False
        self.reduce_gradients()
        if self.use_scaler:
            found_inf = self.unscale_()
            with allow_sync():  # the fp16 step's one readback (JAX's `bool(finite)`)
                skipped = bool(found_inf.item())
            self.scaler.update(skipped)
        if not skipped:
            with self._mixed_update():
                self.optimizer.step()
            if self.layout is not None:
                self.layout.after_step()
        self._found_inf = None
        self._reduced = False
        self.step_was_skipped = skipped
        return skipped

    def step(self):
        """Apply the update at a sync boundary; a no-op (marked skipped)
        while accumulating, when there are no gradients, or under fp16 when
        a gradient is not finite."""
        if not self.gradient_state.sync_gradients:
            self.step_was_skipped = True
            return
        self.reduce_gradients()
        if not self._grads():
            self.step_was_skipped = True
            self._reduced = False
            return
        self.apply_or_skip()

    def zero_grad(self, set_to_none: bool = True):
        """Clear the gradients; a no-op mid-accumulation."""
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)
            if self.layout is not None:
                for param in self.layout.orig.values():
                    param.grad = None
            self._found_inf = None
            self._reduced = False

    def clip_grad_norm_(self, max_norm: float) -> Optional[torch.Tensor]:
        """Unscale (under fp16), then clip the accumulated gradients by
        global norm; returns the pre-clip norm, or None when there are
        none."""
        self.unscale_()
        if not self._grads():
            return None
        return clip_grad_norm(self._params(), max_norm, layout=self.layout)

    def clip_grad_value_(self, clip_value: float):
        """Unscale (under fp16), then clamp every accumulated gradient to
        [-clip_value, clip_value], element by element (JAX's
        `clip_grad_value_`). Under a sharded layout each process clamps its
        own shards: no collective. As in JAX, the step's non-finite check
        then reads the clamped gradients, in which only a NaN is left
        non-finite."""
        found_inf = self.unscale_()
        grads = self._grads()
        if not grads:
            return
        torch._foreach_clamp_min_(grads, -clip_value)
        torch._foreach_clamp_max_(grads, clip_value)
        if found_inf is not None:
            self._found_inf = unscale_grads(grads, 1.0)
            if self.layout is not None and dist.get_world_size() > 1:
                dist.all_reduce(self._found_inf, op=dist.ReduceOp.MAX)

    def set_learning_rate(self, lr: float):
        """Override the learning rate for the following steps."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    @property
    def learning_rate(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def state_dict(self) -> dict:
        """The optimizer's state dict, every moment whole (collective across
        processes)."""
        if self.layout is None:
            return self.optimizer.state_dict()
        return self.layout.full_optimizer_state(self.optimizer)

    def load_state_dict(self, state: dict):
        """Load a whole state dict (from any layout), each process taking its
        shard."""
        if self.layout is None:
            self.optimizer.load_state_dict(state)
        else:
            self.layout.load_full_optimizer_state(self.optimizer, state)
