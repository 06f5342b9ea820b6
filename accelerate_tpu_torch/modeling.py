"""Model bundles and the prepared-model wrapper (the port of
`accelerate_tpu/modeling.py`'s `Model` and `PreparedModel`).

A `Model` pairs an `nn.Module` with the loss that `Accelerator.backward` and
`train_step` use by default; `Accelerator.prepare` takes either that or the
module alone, whose `loss_fn` attribute (the port's Llama carries
`causal_lm_loss`) is then the bundled loss.

`PreparedModel` runs the module on the accelerator's device under the
mixed-precision contract of JAX's `PreparedModel._mp_apply`: the master
parameters stay as they are (f32), the forward runs on compute-dtype copies
cast inside the autograd graph (`torch.func.functional_call`), so the
gradients land on the masters in their own dtype; floating inputs are cast
the same way and floating outputs come back as f32. `torch.autocast` would
not match it: it keeps the norm scales and the embedding in f32 and casts
other ops than JAX does. `autocast_enabled` (True when there is a compute
dtype, unless `AutocastKwargs(enabled=False)`; `Accelerator.autocast`
toggles it) says whether the casts happen: without them the module runs in
its masters' dtype, as JAX's does. With a `remat_policy` the forward runs inside
`ops.remat.remat_scope`, so every in-tree layer is checkpointed (JAX's
`PreparedModel(remat_policy=...)`). With an `fp8_recipe` (mixed precision
"fp8": bf16 copies) the forward runs inside `ops.fp8.fp8_autocast`, so every
linear layer's product is an fp8 one.

Under a process group (`mesh`), the module is placed by the FSDP plugin's
strategy (`parallel.fsdp.ShardedLayout`: data parallel, ZeRO-2 or torch's
FSDP), after its parameters are cast to the plugin's `param_dtype` and, with
`sync_module_states`, broadcast from process 0. Under FSDP the managed
parameters reach the forward already cast by FSDP's mixed-precision policy,
so `_apply` casts only the rest (the parameters FSDP ignores, and the
buffers): each tensor is cast once.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from torch.distributed.tensor import DTensor

from .ops.fp8 import fp8_autocast
from .ops.remat import check_policy, remat_scope
from .parallel.fsdp import ShardedLayout, broadcast_module_states

#: `FullyShardedDataParallelPlugin`'s dtype names.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

logger = logging.getLogger(__name__)


@dataclass
class Model:
    """An `nn.Module` and its default loss, ``loss_fn(batch, apply_fn)``."""

    module: nn.Module
    loss_fn: Optional[Callable] = None

    def parameters(self):
        return self.module.parameters()

    # ------------------------------------------------------------ across processes
    def no_sync(self):
        """Microbatches inside reduce no gradient (the step reduces once)."""
        return self.layout.no_sync() if self.layout is not None else contextlib.nullcontext()

    def reduce_gradients(self):
        """Average the gradients over the processes, where the strategy
        leaves that to the step (a no-op with one process and no group)."""
        if self.layout is not None:
            self.layout.reduce_gradients()

    def full_state_dict(self) -> dict:
        """The whole state dict, every tensor unsharded (collective under a
        group)."""
        if self.layout is None:
            return self.module.state_dict()
        return self.layout.full_state_dict()

    def load_full_state_dict(self, state: dict):
        """Load a whole state dict, each process taking its shard."""
        if self.layout is None:
            self.module.load_state_dict(state)
        else:
            self.layout.load_full_state_dict(state)


def _cast_floating(tree, dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floating(v, dtype) for v in tree)
    return tree


class PreparedModel:
    """A model placed on the device, called under the precision policy.

    `__call__` runs the forward; `loss(batch)` the bundled loss on it (the
    argument to `Accelerator.backward` and the fused step's default)."""

    def __init__(self, model: Model, device: torch.device, compute_dtype: Optional[torch.dtype] = None,
                 remat_policy: Optional[str] = None, fp8_recipe=None, mesh=None, fsdp_plugin=None,
                 autocast: bool = True):
        self.module = model.module.to(device)
        self.loss_fn = model.loss_fn
        self.device = device
        self.compute_dtype = compute_dtype
        self.autocast_enabled = autocast and compute_dtype is not None
        self.remat_policy = check_policy(remat_policy)
        self.fp8_recipe = fp8_recipe
        self.param_dtype = _DTYPES[fsdp_plugin.param_dtype] if getattr(fsdp_plugin, "param_dtype", None) else None
        self.reduce_dtype = _DTYPES[fsdp_plugin.reduce_dtype] if getattr(fsdp_plugin, "reduce_dtype", None) else None
        if self.param_dtype is not None:
            for param in self.module.parameters():
                if param.is_floating_point():
                    param.data = param.data.to(self.param_dtype)
        self.layout: Optional[ShardedLayout] = None
        if mesh is not None:
            if mesh.size() > 1:
                from .parallel.expert import MoEBlock

                if any(isinstance(m, MoEBlock) for m in self.module.modules()):
                    raise NotImplementedError(
                        "a mixture-of-experts model across processes waits for ROADMAP A item 3, expert "
                        "sharding: JAX routes over the global token axis (capacity and slot order), which a "
                        "router on each process's rows would not reproduce")
                if fp8_recipe is not None:
                    raise NotImplementedError(
                        "fp8 across processes waits for ROADMAP A item 3, fp8 across processes (an all-reduce of "
                        "each global amax): JAX scales by the amax over the global batch, each process here by its own")
                if fsdp_plugin is not None and fsdp_plugin.sync_module_states:
                    broadcast_module_states(self.module)
            self.layout = ShardedLayout(self.module, mesh, fsdp_plugin,
                                        compute_dtype=compute_dtype if self.autocast_enabled else None,
                                        reduce_dtype=self.reduce_dtype)
        if fp8_recipe is not None and fp8_recipe.scaling == "delayed":
            # The forward never rolls the histories, so every layer keeps
            # the cold scale 1.0: JAX's prepared model computes the same.
            logger.warning(
                "FP8RecipeKwargs(scaling='delayed') through the prepared-model path keeps amax "
                "histories frozen at their init scale (the forward does not update them). Use the "
                "default dynamic scaling, or thread meta explicitly via ops.fp8.fp8_matmul_delayed / "
                "fp8_autocast(recipe, update_meta=True)."
            )

    def _mp_apply(self, *args, **kwargs):
        fp8 = contextlib.nullcontext() if self.fp8_recipe is None else fp8_autocast(self.fp8_recipe)
        with fp8, remat_scope(self.remat_policy):
            return self._apply(*args, **kwargs)

    def _apply(self, *args, **kwargs):
        if not self.autocast_enabled:
            return self.module(*args, **kwargs)
        # The casts are autograd ops: the backward casts each gradient back
        # to its master's dtype. FSDP casts the parameters it manages (the
        # DTensors) itself.
        tensors = {
            name: t.to(self.compute_dtype) if t.is_floating_point() else t
            for name, t in (*self.module.named_parameters(), *self.module.named_buffers())
            if not isinstance(t, DTensor)
        }
        args = _cast_floating(args, self.compute_dtype)
        kwargs = _cast_floating(kwargs, self.compute_dtype)
        out = torch.func.functional_call(self.module, tensors, args, kwargs)
        return _cast_floating(out, torch.float32)

    def __call__(self, *args, **kwargs):
        return self._mp_apply(*args, **kwargs)

    def loss(self, batch):
        """The bundled loss under this model's precision policy."""
        if self.loss_fn is None:
            raise ValueError("This model bundle has no loss_fn; pass your own loss to backward()")
        return self.loss_fn(batch, self._mp_apply)

    def parameters(self):
        return self.module.parameters()

    # ------------------------------------------------------------ across processes
    def no_sync(self):
        """Microbatches inside reduce no gradient (the step reduces once)."""
        return self.layout.no_sync() if self.layout is not None else contextlib.nullcontext()

    def reduce_gradients(self):
        """Average the gradients over the processes, where the strategy
        leaves that to the step (a no-op with one process and no group)."""
        if self.layout is not None:
            self.layout.reduce_gradients()

    def full_state_dict(self) -> dict:
        """The whole state dict, every tensor unsharded (collective under a
        group)."""
        if self.layout is None:
            return self.module.state_dict()
        return self.layout.full_state_dict()

    def load_full_state_dict(self, state: dict):
        """Load a whole state dict, each process taking its shard."""
        if self.layout is None:
            self.module.load_state_dict(state)
        else:
            self.layout.load_full_state_dict(state)

    @property
    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def __repr__(self):
        return (
            f"PreparedModel(params={self.num_parameters:,}, device={self.device}, "
            f"compute_dtype={self.compute_dtype}, remat_policy={self.remat_policy}, fp8_recipe={self.fp8_recipe})"
        )
