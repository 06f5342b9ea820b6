"""The accelerated optimizer (the port of `accelerate_tpu/optimizer.py`'s
`AcceleratedOptimizer` and its clipping rule).

It wraps a `torch.optim.Optimizer` built over the module's parameters.
Gradients accumulate in the parameters' ``.grad`` as autograd leaves them;
`step` applies the update only at a sync boundary and `zero_grad` clears
only there, so microbatches in between keep adding up (the JAX package's
eager contract). The learning rate a scheduler installs
(`set_learning_rate`) is written into every parameter group at once, so the
eager and the fused step read the same value.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from .state import GradientState


def clip_grad_norm(parameters: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients by ``min(1, max_norm / (norm + 1e-6))``, the norm
    being the global L2 norm over every gradient in fp32 (JAX's
    `unscale_and_clip`); returns the pre-clip norm as a 0-d tensor."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm


class AcceleratedOptimizer:
    """A `torch.optim.Optimizer` bound to a prepared model."""

    def __init__(self, optimizer: torch.optim.Optimizer, model=None):
        self.optimizer = optimizer
        self.model = model
        self.gradient_state = GradientState()
        self.step_was_skipped = False

    def _params(self):
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def _has_grads(self) -> bool:
        return any(p.grad is not None for p in self._params())

    def step(self):
        """Apply the update at a sync boundary; a no-op (marked skipped)
        while accumulating or when there are no gradients."""
        if not self.gradient_state.sync_gradients or not self._has_grads():
            self.step_was_skipped = True
            return
        self.optimizer.step()
        self.step_was_skipped = False

    def zero_grad(self, set_to_none: bool = True):
        """Clear the gradients; a no-op mid-accumulation."""
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    def clip_grad_norm_(self, max_norm: float) -> Optional[torch.Tensor]:
        """Clip the accumulated gradients by global norm; returns the
        pre-clip norm, or None when there are none."""
        if not self._has_grads():
            return None
        return clip_grad_norm(self._params(), max_norm)

    def set_learning_rate(self, lr: float):
        """Override the learning rate for the following steps."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    @property
    def learning_rate(self) -> float:
        return self.optimizer.param_groups[0]["lr"]
