"""Learning-rate scheduler wrapper (the port of `accelerate_tpu/scheduler.py`).

`AcceleratedScheduler` takes a schedule function (``step -> lr``, like an
optax schedule) or a torch scheduler (anything with ``get_last_lr()``), and
pushes its learning rate into the prepared optimizers. With
`step_with_optimizer` (the default) it advances only when the optimizers
really stepped: not while gradients accumulate, not after a skipped step;
and then by `num_processes` steps unless `split_batches`, so that the
schedule's progress follows the global batch, as JAX's does. Without
`step_with_optimizer` it advances one step per call.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

from .state import GradientState, PartialState


class AcceleratedScheduler:
    def __init__(self, scheduler: Union[Callable, object], optimizers, step_with_optimizer: bool = True,
                 split_batches: bool = False):
        self.scheduler = scheduler
        self.optimizers = optimizers if isinstance(optimizers, (list, tuple)) else [optimizers]
        self.split_batches = split_batches
        self.step_with_optimizer = step_with_optimizer
        self.gradient_state = GradientState()
        self._step_count = 0
        self._last_lr: Optional[List[float]] = None
        # Seed the optimizers with the schedule's initial learning rate.
        self._apply_lr()

    def _compute_lr(self) -> Optional[float]:
        if callable(self.scheduler):
            return float(self.scheduler(self._step_count))
        if hasattr(self.scheduler, "get_last_lr"):
            lr = self.scheduler.get_last_lr()
            return float(lr[0]) if isinstance(lr, (list, tuple)) else float(lr)
        return None

    def _apply_lr(self):
        lr = self._compute_lr()
        if lr is not None:
            for opt in self.optimizers:
                opt.set_learning_rate(lr)
            self._last_lr = [lr]

    def step(self, *args, **kwargs):
        if self.step_with_optimizer:
            if not self.gradient_state.sync_gradients:
                return
            if any(opt.step_was_skipped for opt in self.optimizers):
                return
            # Each process's batch is one of num_processes that make the
            # global batch, unless the loader's batch is the global one.
            self._step_count += 1 if self.split_batches else PartialState().num_processes
        else:
            self._step_count += 1
        if not callable(self.scheduler) and hasattr(self.scheduler, "step"):
            self.scheduler.step(*args, **kwargs)
        self._apply_lr()

    def state_dict(self) -> dict:
        """The step count, the last learning rate and a torch scheduler's own
        state (JAX's keys)."""
        inner = None
        if not callable(self.scheduler) and hasattr(self.scheduler, "state_dict"):
            inner = self.scheduler.state_dict()
        return {"step_count": self._step_count, "last_lr": self._last_lr, "inner": inner}

    def load_state_dict(self, state: dict):
        """Restore `state_dict()` and push the learning rate into the optimizers."""
        self._step_count = state["step_count"]
        self._last_lr = state.get("last_lr")
        if state.get("inner") is not None and hasattr(self.scheduler, "load_state_dict"):
            self.scheduler.load_state_dict(state["inner"])
        self._apply_lr()

    def get_last_lr(self) -> Optional[List[float]]:
        return self._last_lr

    @property
    def step_count(self) -> int:
        return self._step_count
