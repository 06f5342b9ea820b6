"""Data parallel and FSDP/ZeRO over `torch.distributed`: how `prepare`
places a model on the ("data", "fsdp") mesh, and how its gradients and
optimizer state follow (the port of what GSPMD does for the JAX package's
`PreparedModel` under `derive_param_shardings`).

`ShardedLayout` applies the placement table of `parallel.sharding`:

  - FULL_SHARD and HYBRID_SHARD (parameters sharded): torch's FSDP
    (`fully_shard`) on every entry of the model's layer lists and on the
    root, each managed parameter placed with ``Shard(dim)`` on the table's
    dim (`shard_placement_fn`) over "fsdp", replicated over "data" (a 2-D
    mesh); the parameters the table replicates are FSDP's
    `ignored_params`, whose gradients this module all-reduces. FSDP's
    mixed-precision policy casts the managed parameters to the compute
    dtype; the prepared model casts the rest.
  - SHARD_GRAD_OP and HYBRID_SHARD_ZERO2 (ZeRO-2): the parameters stay
    replicated; the gradient of each parameter whose moments the table
    shards is reduce-scattered over "fsdp" (all-reduced over "data") onto
    a shard, the optimizer updates that shard (a view into the replicated
    parameter) and its moments, and the shards are all-gathered back after
    the update.
  - NO_SHARD, and no plugin: data parallel, every gradient all-reduced in
    one flat buffer per dtype.

Every reduction averages over all the processes; the losses' global mean
(`ops.losses.global_mean`) gives each the gradient that average expects.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from .sharding import derive_opt_state_placements, derive_param_placements


@torch.no_grad()
def broadcast_module_states(module: nn.Module):
    """Every parameter and buffer of `module` as process 0 holds it (FSDP's
    `sync_module_states`); run before anything is sharded."""
    for tensor in (*module.parameters(), *module.buffers()):
        dist.broadcast(tensor.data, src=0)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _units(module: nn.Module) -> List[nn.Module]:
    """The FSDP units below the root: every entry of a `ModuleList`, the
    deepest first."""
    units = []
    for name, sub in module.named_modules():
        if isinstance(sub, nn.ModuleList):
            units += [(name.count(".") + 1, child) for child in sub]
    return [child for _, child in sorted(units, key=lambda u: -u[0])]


class ShardedLayout:
    """A module's placement on the mesh, applied at construction.

    `update` maps each parameter name to the tensor the optimizer updates
    (the sharded `DTensor` under FSDP, a shard view under ZeRO-2, the
    parameter itself otherwise); `param_dims` and `opt_dims` are the
    tables it was built from."""

    def __init__(self, module: nn.Module, mesh, fsdp_plugin=None, compute_dtype: Optional[torch.dtype] = None,
                 reduce_dtype: Optional[torch.dtype] = None):
        self.module = module
        self.mesh = mesh
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        self.data_size, self.fsdp_size = int(sizes["data"]), int(sizes["fsdp"])
        self.world = self.data_size * self.fsdp_size
        self.fsdp_group = mesh["fsdp"].get_group()
        self.data_group = mesh["data"].get_group()
        self.fsdp_index = mesh["fsdp"].get_local_rank()
        self.param_dims = derive_param_placements(module, sizes, fsdp_plugin, shard_single=True)
        self.opt_dims = derive_opt_state_placements(module, sizes, fsdp_plugin, shard_single=True)
        params = dict(module.named_parameters())
        # The optimizer a user built holds the original parameters: `adopt`
        # finds them by id.
        self._names_by_id = {id(p): n for n, p in params.items()}
        self.uses_fsdp = any(d is not None for d in self.param_dims.values())
        if self.uses_fsdp:
            self._wrap(params, compute_dtype, reduce_dtype)
        del params
        # After the wrap: the sharded `DTensor`s and the ignored parameters.
        self.orig: Dict[str, nn.Parameter] = dict(module.named_parameters())
        if self.uses_fsdp:
            self.update = dict(self.orig)
            self.shard_dims = dict(self.param_dims)
        else:
            self.update = {}
            for name, param in self.orig.items():
                dim = self.opt_dims[name]
                if dim is None:
                    self.update[name] = param
                else:
                    size = param.shape[dim] // self.fsdp_size
                    self.update[name] = nn.Parameter(param.detach().narrow(dim, self.fsdp_index * size, size))
            self.shard_dims = dict(self.opt_dims)
        self._sharded_ids = {id(self.update[n]) for n, d in self.shard_dims.items() if d is not None}
        self._names_by_id.update({id(t): n for n, t in self.update.items()})

    # ------------------------------------------------------------ placement
    def _wrap(self, params: Dict[str, nn.Parameter], compute_dtype, reduce_dtype):
        from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
        from torch.distributed.tensor import Shard

        place = {id(params[n]): Shard(d) for n, d in self.param_dims.items() if d is not None}
        ignored = {p for n, p in params.items() if self.param_dims[n] is None}
        storage = next(iter(params.values())).dtype
        policy = MixedPrecisionPolicy(param_dtype=compute_dtype, reduce_dtype=reduce_dtype or storage,
                                      cast_forward_inputs=False)
        kwargs = dict(mesh=self.mesh if self.data_size > 1 else self.mesh["fsdp"], reshard_after_forward=True,
                      shard_placement_fn=lambda p: place.get(id(p)), mp_policy=policy, ignored_params=ignored)
        for unit in _units(self.module):
            if any(id(p) in place for p in unit.parameters()):
                fully_shard(unit, **kwargs)
        fully_shard(self.module, **kwargs)

    def adopt(self, optimizer: torch.optim.Optimizer):
        """Point `optimizer` (built over the module's original parameters)
        at the tensors it updates here, in place and in the same order."""
        if optimizer.state:
            raise ValueError("prepare the optimizer before its first step: its state cannot be re-placed")
        for group in optimizer.param_groups:
            params = []
            for p in group["params"]:
                name = self._names_by_id.get(id(p))
                if name is None:
                    raise ValueError("the optimizer was built over other parameters than the model's")
                params.append(self.update[name])
            group["params"] = params

    def is_sharded(self, tensor) -> bool:
        return id(tensor) in self._sharded_ids

    def name_of(self, tensor) -> str:
        return self._names_by_id[id(tensor)]

    # ------------------------------------------------------------ gradients
    @contextlib.contextmanager
    def no_sync(self):
        """Microbatches inside add to the local gradients and reduce nothing
        (FSDP's `set_requires_gradient_sync(False)`; elsewhere the reduction
        is `reduce_gradients`, which the caller runs once a step)."""
        if not self.uses_fsdp:
            yield
            return
        self.module.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            self.module.set_requires_gradient_sync(True)

    @torch.no_grad()
    def reduce_gradients(self):
        """Average the gradients FSDP does not reduce itself over every
        process: the replicated ones in one all-reduce per dtype; under
        ZeRO-2 each sharded one reduce-scattered onto its shard (whose
        `.grad` it becomes; the full gradient is dropped)."""
        replicated: Dict[torch.dtype, List[torch.Tensor]] = {}
        for name, param in self.orig.items():
            grad = param.grad
            if grad is None or isinstance(grad, DTensor):
                continue
            dim = None if self.uses_fsdp else self.opt_dims[name]
            if dim is None:
                replicated.setdefault(grad.dtype, []).append(grad)
                continue
            chunks = grad.movedim(dim, 0).contiguous()
            out = chunks.new_empty((chunks.shape[0] // self.fsdp_size, *chunks.shape[1:]))
            dist.reduce_scatter_tensor(out, chunks, group=self.fsdp_group)
            if self.data_size > 1:
                dist.all_reduce(out, group=self.data_group)
            self.update[name].grad = out.div_(self.world).movedim(0, dim)
            param.grad = None
        for grads in replicated.values():
            flat = torch._utils._flatten_dense_tensors(grads)
            dist.all_reduce(flat)
            flat.div_(self.world)
            for grad, synced in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
                grad.copy_(synced)

    @torch.no_grad()
    def after_step(self):
        """ZeRO-2: all-gather the updated shards back into the replicated
        parameters."""
        if self.uses_fsdp:
            return
        for name, dim in self.shard_dims.items():
            if dim is not None:
                self.orig[name].copy_(self.gather(self.update[name], dim))

    def grad_norm(self, params: Iterable[torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of the gradients of `params` (the optimizer's
        tensors) in f32, taken as the one-process step takes it (the norm of
        the per-tensor norms): a sharded gradient's norm is the root of its
        shards' squares summed over "fsdp" (one all-reduce for all of them;
        over a one-member axis the shard is the whole gradient)."""
        entries = [(self.is_sharded(p), torch.linalg.vector_norm(_local(p.grad).float()))
                   for p in params if p.grad is not None]
        if self.fsdp_size > 1 and any(sharded for sharded, _ in entries):
            squares = torch.stack([norm for sharded, norm in entries if sharded]).square()
            dist.all_reduce(squares, group=self.fsdp_group)
            roots = iter(squares.sqrt().unbind(0))
            entries = [(sharded, next(roots) if sharded else norm) for sharded, norm in entries]
        return torch.linalg.vector_norm(torch.stack([norm for _, norm in entries]))

    # ------------------------------------------------------------ full state
    def gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from this process's shard on `dim` (collective
        over "fsdp")."""
        shard = _local(shard).detach()
        chunks = shard.movedim(dim, 0).contiguous()
        parts = [torch.empty_like(chunks) for _ in range(self.fsdp_size)]
        dist.all_gather(parts, chunks, group=self.fsdp_group)
        return torch.cat(parts, dim=0).movedim(0, dim)

    def shard(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This process's shard of a whole tensor on `dim`."""
        return full.chunk(self.fsdp_size, dim=dim)[self.fsdp_index]

    def full_state_dict(self) -> dict:
        """The module's state dict with every tensor whole, on the CPU
        (collective: every process calls it)."""
        out = {}
        for name, value in self.module.state_dict().items():
            dim = self.param_dims.get(name) if self.uses_fsdp else None
            if dim is not None:
                value = self.gather(value, dim)
            out[name] = _local(value).detach().to("cpu", copy=True)
        return out

    @torch.no_grad()
    def load_full_state_dict(self, state: dict):
        """Take each process's part of a whole state dict (one written by
        any layout, or by one process)."""
        current = dict(self.module.named_parameters())
        current.update(self.module.named_buffers())
        missing = sorted(set(current) - set(state))
        unexpected = sorted(set(state) - set(self.module.state_dict()))
        if missing or unexpected:
            raise KeyError(f"state dict does not match the model: missing {missing[:5]}, unexpected {unexpected[:5]}")
        for name, target in current.items():
            value = state[name]
            dim = self.param_dims.get(name) if self.uses_fsdp else None
            if dim is not None:
                value = self.shard(value, dim)
            _local(target).copy_(value)

    def _optimizer_names(self, optimizer) -> List[str]:
        return [self.name_of(p) for group in optimizer.param_groups for p in group["params"]]

    def full_optimizer_state(self, optimizer) -> dict:
        """`optimizer.state_dict()` with every moment whole, on the CPU
        (collective)."""
        state = optimizer.state_dict()
        names = self._optimizer_names(optimizer)
        packed = {}
        for index, entry in state["state"].items():
            dim = self.shard_dims[names[index]]
            packed[index] = {
                key: (self.gather(value, dim) if dim is not None else _local(value)).detach().to("cpu", copy=True)
                if torch.is_tensor(value) and value.dim() > 0 else value
                for key, value in entry.items()
            }
        return {"state": packed, "param_groups": state["param_groups"]}

    def load_full_optimizer_state(self, optimizer, state: dict):
        """Load a whole optimizer state dict, each moment cut to this
        process's shard (as a `DTensor` where the parameter is one)."""
        params = [p for group in optimizer.param_groups for p in group["params"]]
        names = self._optimizer_names(optimizer)
        placed = {}
        for index, entry in state["state"].items():
            index = int(index)
            dim, param = self.shard_dims[names[index]], params[index]
            placed[index] = {}
            for key, value in entry.items():
                if torch.is_tensor(value) and value.dim() > 0:
                    value = value.to(_local(param).device)
                    if dim is not None:
                        value = self.shard(value, dim).contiguous()
                    if isinstance(param, DTensor):
                        value = DTensor.from_local(value, param.device_mesh, param.placements, run_check=False)
                placed[index][key] = value
        optimizer.load_state_dict({"state": placed, "param_groups": state["param_groups"]})
