"""Schedule-free AdamW (Defazio et al., "The Road Less Scheduled", 2024): the
function that optax 0.2.6's ``optax.contrib.schedule_free_adamw`` and
``optax.contrib.schedule_free_eval_params`` compute, as a
`torch.optim.Optimizer`. The JAX package's `examples/by_feature/schedule_free.py`
takes them from optax; torch ships no schedule-free optimizer.

Three sequences: the iterate `z`, moved by AdamW without momentum
(``scale_by_rms(b2, eps, eps_in_sqrt=False, bias_correction=True)``, then
decoupled weight decay, then the learning rate); the average `x`, to which
each new `z` is added with the weight ``max_lr**weight_lr_power`` over the
running sum of those weights; and the point the gradient is taken at, ``y =
b1 * x + (1 - b1) * z``, which is what the model's parameters hold. No
learning-rate schedule is needed beyond an optional linear warm-up from 0
(``warmup_steps``, optax's `warmup_constant_schedule`). As in optax, the
AdamW chain reads that schedule at its own count (0 on the first step) and
the averaging weight at the wrapper's (1 on the first step). Evaluate at
`x`: `schedule_free_eval_params(optimizer, model)` returns it, and
`eval_params_in(model, params)` runs a block with them in place.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch


def _schedule(lr: float, warmup_steps: Optional[int], count: int) -> torch.Tensor:
    """optax's ``warmup_constant_schedule(0, lr, warmup_steps)`` at `count`,
    in f32 (the learning rate itself without warm-up)."""
    if warmup_steps is None:
        return torch.tensor(lr, dtype=torch.float32)
    clipped = torch.tensor(min(max(count, 0), warmup_steps), dtype=torch.float32)
    frac = 1 - clipped / warmup_steps
    return (0.0 - lr) * frac + lr


def _power(base: float, exponent: int) -> torch.Tensor:
    """``base ** exponent`` for an f32 `base`, rounded once to f32 (optax's
    bias correction ``1 - b2**count``, whose last bits matter: it is near
    0). XLA's fused f32 power gives this rounding for b2 = 0.999 at every
    count up to 3000 but one."""
    return torch.tensor(float(torch.tensor(base, dtype=torch.float32)) ** exponent, dtype=torch.float32)


class ScheduleFreeAdamW(torch.optim.Optimizer):
    """``optax.contrib.schedule_free_adamw(learning_rate, warmup_steps, b1,
    b2, eps, weight_decay, weight_lr_power)`` with optax's defaults. The
    parameters hold `y`; each parameter's state keeps `z`, the second
    moment and the shared counters. f32 arithmetic for f32 parameters."""

    def __init__(self, params, learning_rate: float = 0.0025, warmup_steps: Optional[int] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 weight_lr_power: float = 2.0):
        if not b1 > 0:
            raise ValueError(f"schedule-free needs b1 > 0, got {b1}")
        defaults = dict(lr=learning_rate, warmup_steps=warmup_steps, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay, weight_lr_power=weight_lr_power)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0  # the AdamW chain's count; the wrapper's is one more
                    state["weight_sum"] = torch.zeros((), dtype=p.dtype, device=p.device)
                    state["max_lr"] = torch.zeros((), dtype=p.dtype, device=p.device)
                    state["z"] = p.detach().clone()
                    state["nu"] = torch.zeros_like(p)
                count = state["step"]
                lr_inner = _schedule(group["lr"], group["warmup_steps"], count).to(p.device, p.dtype)
                lr_outer = _schedule(group["lr"], group["warmup_steps"], count + 1).to(p.device, p.dtype)
                max_lr = torch.maximum(state["max_lr"], lr_outer)
                weight = max_lr ** group["weight_lr_power"]
                total = state["weight_sum"] + weight
                ck = torch.nan_to_num(weight / total, nan=0.0, posinf=float("inf"))
                ck = torch.where(torch.isnan(weight) | torch.isnan(total), torch.full_like(ck, float("nan")), ck)

                g = p.grad
                nu = state["nu"].mul_(b2).add_((1 - b2) * g.square())
                correction = 1 - _power(b2, count + 1)
                update = (1 / (torch.sqrt(nu / correction.to(p.device, p.dtype)) + eps)) * g
                update = (update + group["weight_decay"] * p) * -lr_inner
                z_old = state["z"]
                z = z_old + update
                prev_x = (p - (1.0 - b1) * z_old) / b1
                x = (1.0 - ck) * prev_x + ck * z
                y = b1 * x + (1.0 - b1) * z
                p.add_(y - p)

                state["z"] = z
                state["step"] = count + 1
                state["weight_sum"] = total
                state["max_lr"] = max_lr
        return loss


def _optimizer(optimizer) -> ScheduleFreeAdamW:
    inner = getattr(optimizer, "optimizer", optimizer)  # an `AcceleratedOptimizer` holds it
    if not isinstance(inner, ScheduleFreeAdamW):
        raise ValueError("schedule_free_eval_params needs a ScheduleFreeAdamW (or a prepared one)")
    return inner


def _named_parameters(model):
    module = getattr(model, "module", model)  # a `PreparedModel` holds it
    return module.named_parameters()


@torch.no_grad()
def schedule_free_eval_params(optimizer, model) -> Dict[str, torch.Tensor]:
    """The averaged sequence ``x = (y - (1 - b1) * z) / b1`` of every
    parameter of `model` the optimizer updates (optax's
    `schedule_free_eval_params`), by name; a parameter the optimizer has not
    stepped yet is its own value."""
    inner = _optimizer(optimizer)
    b1 = {id(p): g["b1"] for g in inner.param_groups for p in g["params"]}
    out = {}
    for name, p in _named_parameters(model):
        state = inner.state.get(p)
        if not state or id(p) not in b1:
            out[name] = p.detach().clone()
            continue
        b = torch.tensor(b1[id(p)], dtype=p.dtype, device=p.device)
        out[name] = (p - (1.0 - b) * state["z"]) / b
    return out


@contextlib.contextmanager
def eval_params_in(model, params: Dict[str, torch.Tensor]):
    """Run the block with `params` (by name) in `model`'s parameters; the
    training values come back on exit."""
    saved = []
    with torch.no_grad():
        for name, p in _named_parameters(model):
            if name in params:
                saved.append((p, p.detach().clone()))
                p.copy_(params[name])
    try:
        yield
    finally:
        with torch.no_grad():
            for p, value in saved:
                p.copy_(value)


def schedule_free_adamw(params, learning_rate: float = 0.0025, warmup_steps: Optional[int] = None,
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                        weight_lr_power: float = 2.0) -> ScheduleFreeAdamW:
    """optax's ``schedule_free_adamw(learning_rate, warmup_steps, b1, b2, eps,
    weight_decay, weight_lr_power)`` over `params`, as a torch optimizer."""
    return ScheduleFreeAdamW(params, learning_rate=learning_rate, warmup_steps=warmup_steps, b1=b1, b2=b2,
                             eps=eps, weight_decay=weight_decay, weight_lr_power=weight_lr_power)
