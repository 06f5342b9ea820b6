"""Local SGD (the port of `accelerate_tpu/local_sgd.py`): each data-parallel
process steps on its own gradients for `local_sgd_steps` steps, then the
parameters are averaged across the processes, one all-reduce per K steps
instead of one per step.

    with LocalSGD(accelerator=accelerator, model=model, local_sgd_steps=8) as local_sgd:
        for batch in loader:
            loss = accelerator.backward(model.loss, batch)
            optimizer.step(); optimizer.zero_grad()
            local_sgd.step()

Inside the block the model's layout reduces no gradient, and each loss is
its process's own mean (`ops.losses.local_means`): the gradient is the
process's alone, as each replica's in JAX's vmapped loss, and the value
reported is the mean of the processes' means. The optimizer's state stays
each process's own. The rules are JAX's: only the "data" axis may be above
1; the disk tier is refused (JAX stacks the state of every replica on the
device); on exit a pinned host tier is collapsed onto the card with JAX's
warning; `enabled=False`, one process or one data replica turn it into a
step counter.
"""

from __future__ import annotations

import contextlib
import logging

import torch
import torch.distributed as dist

from .ops.losses import local_means
from .state import AcceleratorState
from .utils.dataclasses import DistributedType

logger = logging.getLogger(__name__)


class LocalSGD:
    """Run `local_sgd_steps` updates independently on each data-parallel
    process, then average the model's parameters."""

    def __init__(self, accelerator, model, local_sgd_steps: int, enabled: bool = True):
        self.accelerator = accelerator
        self.model = model
        self.local_sgd_steps = int(local_sgd_steps)
        self.num_steps = 0
        mesh = AcceleratorState().mesh
        sizes = {}
        if mesh is not None:
            # The port's mesh holds "data" and "fsdp" (it refuses the other
            # axes above 1). Only pure data parallelism, as in JAX.
            sizes = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))
            for axis in ("fsdp", "model", "seq", "expert", "stage"):
                if sizes.get(axis, 1) != 1:
                    raise NotImplementedError(
                        f"LocalSGD supports pure data parallelism only (mesh axis {axis!r} has "
                        f"size {sizes[axis]})"
                    )
        self.dp = sizes.get("data", 1)
        self.enabled = enabled and accelerator.distributed_type != DistributedType.NO and self.dp > 1
        self._locals = None

    # ---- context manager -------------------------------------------------------------
    def __enter__(self):
        if self.enabled:
            self._expand()
        return self

    def __exit__(self, exc_type, value, tb):
        if self.enabled:
            self._sync_and_avg_model_params()
            self._collapse()

    def step(self):
        """Count one local step; average the parameters at every
        `local_sgd_steps` boundary."""
        self.num_steps += 1
        if not self.enabled:
            return
        if self.num_steps % self.local_sgd_steps == 0:
            self._sync_and_avg_model_params()

    # ---- the local steps -------------------------------------------------------------
    def _bound_optimizer(self):
        for opt in getattr(self.accelerator, "_optimizers", []):
            if opt.model is self.model:
                return opt
        return None

    def _expand(self):
        opt = self._bound_optimizer()
        if opt is not None and getattr(opt.offload, "tier", None) == "disk":
            raise NotImplementedError(
                "LocalSGD stacks a replica axis into device-resident optimizer "
                "state; offload_optimizer_device='disk' keeps that state on disk. "
                "Use the pinned-host tier (offload_optimizer_state=True) or no "
                "offload with LocalSGD."
            )
        self.model.layout.sync_gradients = False
        self._locals = contextlib.ExitStack()
        self._locals.enter_context(local_means())

    def _collapse(self):
        self.model.layout.sync_gradients = True
        self._locals.close()
        self._locals = None
        opt = self._bound_optimizer()
        if opt is not None and opt.offload is not None:
            # JAX's collapse loses the shardings the host tier needs and keeps
            # the state on the device: the port does the same.
            logger.warning(
                "LocalSGD collapse disables optimizer-state host offload; "
                "state stays in device memory from here on."
            )
            tier = opt.offload
            tier.synchronize()
            for i, p in enumerate(tier.params):
                for key in tier.keys:
                    if key in opt.optimizer.state[p]:
                        opt.optimizer.state[p][key] = opt.optimizer.state[p][key].to(p.device, copy=True)
            opt.offload = None

    @torch.no_grad()
    def _sync_and_avg_model_params(self):
        """Average the parameters across the processes: one all-reduce a
        parameter per `local_sgd_steps` steps."""
        self.accelerator.wait_for_everyone()
        world = dist.get_world_size()
        nccl = dist.get_backend() == "nccl"
        for p in self.model.module.parameters():
            data = p.data
            if nccl and data.device.type == "cpu":  # masters in the host tier
                moved = data.to(torch.device("cuda", torch.cuda.current_device()))
                dist.all_reduce(moved)
                data.copy_(moved.div_(world))
            else:
                dist.all_reduce(data)
                data.div_(world)
