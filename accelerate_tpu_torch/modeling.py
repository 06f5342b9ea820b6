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
linear layer's product is an fp8 one; under a process group its amaxes are
the global batch's (`fp8_group`, an all-reduce of each over the processes).

Over a "model" axis the module is first split by its family's Megatron
table or the planner's (`Model.sharding_rules`, `parallel.tensor`): tensor
parallel. The planner's ZeRO table (`Model.opt_sharding_rules`) shards
optimizer moments over "data" (`ShardedLayout`).
Under a process group (`mesh`), the module is placed by the FSDP plugin's
strategy (`parallel.fsdp.ShardedLayout`: data parallel, ZeRO-2 or torch's
FSDP), after its parameters are cast to the plugin's `param_dtype` and, with
`sync_module_states`, broadcast from process 0. Under FSDP the managed
parameters reach the forward already cast by FSDP's mixed-precision policy,
so `_apply` casts only the rest (the parameters FSDP ignores, and the
buffers): each tensor is cast once.

With `offload_params` (JAX's parameter tier) the masters live in one
pinned host arena between steps: `to_compute_memory` copies them to the
card before a forward, outside the autograd graph, so the gradients land
on the card; the optimizer's step updates them there and
`to_storage_memory` writes them back. A forward without gradients puts
them back unchanged right after.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from torch.distributed.tensor import DTensor

from .ops.fp8 import fp8_autocast
from .ops.losses import batch_group
from .ops.remat import check_policy, remat_scope
from .parallel.fsdp import ShardedLayout, broadcast_module_states
from .parallel.mesh import data_parallel_group, mesh_sizes
from .utils.offload import HostArena

#: `FullyShardedDataParallelPlugin`'s dtype names.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

logger = logging.getLogger(__name__)


@dataclass
class Model:
    """An `nn.Module` and its default loss, ``loss_fn(batch, apply_fn)``."""

    module: nn.Module
    loss_fn: Optional[Callable] = None
    #: The family's Megatron table (`(path regex, spec)` pairs) that places
    #: the module over a "model" axis, or ``"auto"``: `Accelerator.prepare`
    #: then plans one (`parallel.planner`) and puts it here.
    sharding_rules: Optional[object] = None
    #: The planner's ZeRO table for the optimizer state
    #: (`ShardingPlan.opt_rules`, moments over "data"), stamped by `prepare`
    #: under ``"auto"``; authoritative for the moments it matches.
    opt_sharding_rules: Optional[list] = None

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
                 autocast: bool = True, offload_params: bool = False):
        # Over a "model" axis the module is split where it lies and only this
        # rank's split moves to the device: a model too large for one card
        # comes in on the host.
        split_first = mesh is not None and mesh_sizes(mesh)["model"] > 1
        self.module = model.module if split_first else model.module.to(device)
        self.loss_fn = model.loss_fn
        self.sharding_rules = model.sharding_rules
        self.opt_sharding_rules = getattr(model, "opt_sharding_rules", None)
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
        #: The group a loss's global mean runs over (`ops.losses.batch_group`).
        self.data_group = data_parallel_group(mesh)
        if mesh is not None:
            if mesh.size() > 1:
                from .parallel.expert import MoEBlock

                if any(isinstance(m, MoEBlock) for m in self.module.modules()):
                    raise NotImplementedError(
                        "a mixture-of-experts model across processes waits for ROADMAP A item 3, expert "
                        "sharding: JAX routes over the global token axis (capacity and slot order), which a "
                        "router on each process's rows would not reproduce")
                if fsdp_plugin is not None and fsdp_plugin.sync_module_states:
                    broadcast_module_states(self.module, device)
            if mesh_sizes(mesh)["model"] > 1:
                if fp8_recipe is not None:
                    raise NotImplementedError(
                        "fp8 mixed precision over a \"model\" axis waits for ROADMAP A item 3, fp8 with tensor "
                        "parallel (each split product's amax over its own rows and columns)")
            self.layout = ShardedLayout(self.module, mesh, fsdp_plugin,
                                        compute_dtype=compute_dtype if self.autocast_enabled else None,
                                        reduce_dtype=self.reduce_dtype, rules=self.sharding_rules,
                                        opt_rules=self.opt_sharding_rules)
            if split_first:
                self.module.to(device)  # in place: the layout's tensors are the module's own
        #: The process group whose fp8 amaxes are reduced together: the
        #: mesh's, whose ("data", "fsdp") axes span every process of the
        #: default group (`parallel.mesh.build_mesh`); None without a mesh.
        self.fp8_group = None
        if fp8_recipe is not None and mesh is not None:
            self.fp8_group = dist.group.WORLD
        self.offload_params = bool(offload_params)
        self._param_arena: Optional[HostArena] = None
        self._params_on_device = True
        if self.offload_params:
            self._offload_params()
        if fp8_recipe is not None and fp8_recipe.scaling == "delayed":
            # The forward never rolls the histories, so every layer keeps
            # the cold scale 1.0: JAX's prepared model computes the same.
            logger.warning(
                "FP8RecipeKwargs(scaling='delayed') through the prepared-model path keeps amax "
                "histories frozen at their init scale (the forward does not update them). Use the "
                "default dynamic scaling, or thread meta explicitly via ops.fp8.fp8_matmul_delayed / "
                "fp8_autocast(recipe, update_meta=True)."
            )

    # ------------------------------------------------------------ parameter tier
    def _offload_params(self):
        if self.layout is not None and any(d is not None for d in (*self.layout.param_dims.values(),
                                                                   *self.layout.opt_dims.values())):
            raise NotImplementedError(
                "offload_params across processes under a sharded strategy waits for ROADMAP A item 4, offload "
                "tiers (the parameter tier under ZeRO-2 shard views and FSDP); the optimizer-state tiers run under "
                "every strategy")
        params = [p for p in self.module.parameters()]
        self._offloaded = params
        self._param_arena = HostArena([(i, tuple(p.shape), p.dtype) for i, p in enumerate(params)],
                                      pin=self.device.type == "cuda")
        with torch.no_grad():
            for i, p in enumerate(params):
                self._param_arena.views[i].copy_(p.data)
                p.data = self._param_arena.views[i]
        self._params_on_device = False

    @torch.no_grad()
    def to_compute_memory(self):
        """The masters copied to the card (a no-op when they are there or
        not offloaded); outside the autograd graph."""
        if self._params_on_device:
            return
        for p in self._offloaded:
            p.data = p.data.to(self.device, non_blocking=True)
        self._params_on_device = True

    @torch.no_grad()
    def to_storage_memory(self, write: bool = True):
        """The masters back in the host arena: copied there when `write`
        (after an update), else only pointed back (nothing changed them)."""
        if self._params_on_device and self._param_arena is not None:
            for i, p in enumerate(self._offloaded):
                view = self._param_arena.views[i]
                if write:
                    view.copy_(p.data, non_blocking=True)
                p.data = view
            self._params_on_device = False

    def _synchronize_params(self):
        if self._param_arena is not None and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _mp_apply(self, *args, **kwargs):
        self.to_compute_memory()
        fp8 = contextlib.nullcontext() if self.fp8_recipe is None else fp8_autocast(self.fp8_recipe,
                                                                                      group=self.fp8_group)
        with fp8, remat_scope(self.remat_policy):
            out = self._apply(*args, **kwargs)
        if self.offload_params and not torch.is_grad_enabled():
            self.to_storage_memory(write=False)
        return out

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
        """The bundled loss under this model's precision policy, its mean
        over the mesh's data ranks (`data_group`)."""
        if self.loss_fn is None:
            raise ValueError("This model bundle has no loss_fn; pass your own loss to backward()")
        with batch_group(self.data_group):
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
        self._synchronize_params()
        if self.layout is None:
            return self.module.state_dict()
        return self.layout.full_state_dict()

    def state_shards(self) -> list:
        """(name, this process's tensor, whole shape, ``[[start, stop],
        ...]``) of every entry of the state dict, without a collective: a
        parameter FSDP shards is this process's shard with its bounds in the
        whole tensor; the rest (every parameter under ZeRO-2, whose moments
        are sharded instead) whole. The sharded checkpoint's entries."""
        self._synchronize_params()
        fsdp = self.layout is not None and self.layout.uses_fsdp
        out = []
        for name, value in self.module.state_dict().items():
            if self.layout is None:
                out.append((name, value.detach(), tuple(value.shape), [[0, int(d)] for d in value.shape]))
            else:
                out.append((name, *self.layout.local_entry(value, self.layout.param_dims.get(name) if fsdp else None)))
        return out

    def load_full_state_dict(self, state: dict):
        """Load a whole state dict, each process taking its shard (copied
        into the module's own tensors: the caller's are not kept)."""
        self._synchronize_params()
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
