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

The offload tiers (JAX's ZeRO-offload, `FullyShardedDataParallelPlugin(
offload_optimizer_state=True)` or ``offload_optimizer_device="disk"``): the
optimizer's per-parameter state (AdamW's moments) lives off the card, in
one pinned host arena (`PinnedOptState`) or in the disk store
(`DiskOptState`), and the update streams it through the card a parameter
group at a time (`offload_groups`: 256 MB of parameters, or
``ACCELERATE_TPU_OFFLOAD_CHUNK_MB``): the group's state is copied in on a
side stream while the previous group updates, the optimizer's own `step`
runs over the group's parameters alone, and the state is copied back on a
second side stream; the disk tier reads group k+1 ahead into pinned
staging and writes each group back on one writer thread. The finite check
and the clip are global and come first, so a skipped fp16 step touches no
group; the optimizer's update is elementwise per tensor, so each group's
update is the resident update's, bit for bit. A group's state is built by
its first update, on the card, and never the whole state at once.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import inspect
import os
import shutil
import tempfile
import weakref
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from .analysis.trace_guard import allow_sync
from .state import GradientState
from .utils.dataclasses import GradScalerKwargs
from .utils.offload import HostArena


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


def offload_groups(nbytes: List[int]) -> List[List[int]]:
    """Consecutive indices cut into groups of at most the chunk budget of
    parameter bytes (``ACCELERATE_TPU_OFFLOAD_CHUNK_MB``, 256 by default; a
    tensor past it makes a group alone), JAX's `_offload_groups`."""
    budget = int(os.environ.get("ACCELERATE_TPU_OFFLOAD_CHUNK_MB", "256")) * 1024 * 1024
    groups, cur, cur_bytes = [], [], 0
    for i, n in enumerate(nbytes):
        if cur and cur_bytes + n > budget:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += n
    if cur:
        groups.append(cur)
    return groups


def state_layout(optimizer: torch.optim.Optimizer) -> Dict[str, Optional[torch.dtype]]:
    """The optimizer's state entries that mirror a parameter, {key: dtype},
    None for "the parameter's dtype": read from one update of a throwaway
    copy of the optimizer (its class and defaults) over a 2-element
    parameter on the CPU."""
    probe = torch.zeros(2, dtype=torch.float64, requires_grad=True)
    probe.grad = torch.ones(2, dtype=torch.float64)
    accepted = inspect.signature(type(optimizer).__init__).parameters
    defaults = {k: v for k, v in optimizer.defaults.items() if k in accepted}
    for key, value in (("foreach", None), ("fused", None), ("capturable", False), ("differentiable", False)):
        if key in defaults:
            defaults[key] = value
    try:
        clone = type(optimizer)([probe], **defaults)
        clone.step()
    except Exception as e:  # noqa: BLE001 - any failure means the optimizer cannot be probed
        raise ValueError(
            f"the offload tiers build {type(optimizer).__name__}'s state a parameter group at a time and need a "
            f"copy of it built from its defaults, which failed: {e}") from e
    return {key: (None if value.dtype == probe.dtype else value.dtype)
            for key, value in clone.state[probe].items()
            if torch.is_tensor(value) and value.shape == probe.shape}


def _wrap_like(param: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """`local` as a tensor of `param`'s kind: a `DTensor` placed as `param`
    is (a state entry of an FSDP parameter), else itself."""
    if isinstance(param, DTensor):
        return DTensor.from_local(local, param.device_mesh, param.placements, run_check=False,
                                  shape=param.shape, stride=param.stride())
    return local


class _OffloadedState:
    """What the two tiers share: the parameter groups, the state layout,
    the device buffers of the groups in flight, the side streams, and the
    chunked update (`run`)."""

    tier = ""

    def __init__(self, optimizer: torch.optim.Optimizer, device: torch.device):
        self.optimizer = optimizer
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.device = device
        self.cuda = device.type == "cuda"
        self.keys = state_layout(optimizer)
        self.groups = offload_groups([_local(p).numel() * _local(p).element_size() for p in self.params])
        self.initialized = [False] * len(self.params)
        self._h2d = self._d2h = None
        #: Bytes copied to and from the card by the updates, and the copies
        #: whose host side was not pinned (0 unless an arena was lost).
        self.stats = {"bytes_in": 0, "bytes_out": 0, "pageable": 0}

    def _dtype(self, i: int, key: str) -> torch.dtype:
        return self.keys[key] or _local(self.params[i]).dtype

    def entries(self):
        """(i, key, shape, dtype) of every offloaded entry, in order."""
        return [(i, key, tuple(_local(p).shape), self._dtype(i, key))
                for i, p in enumerate(self.params) for key in self.keys]

    def check_usable(self):
        pass

    def synchronize(self):
        """Wait for the copies back to the host (before a host reads them)."""
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()

    # -- the update ---------------------------------------------------------
    def _streams(self):
        if self.cuda and self._h2d is None:
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)

    def _host_sources(self, k: int) -> Dict[tuple, torch.Tensor]:
        raise NotImplementedError

    def _stage_in(self, k: int):
        """Group k's initialized state copied to the card (on the copy-in
        stream, after what the main stream has queued so far); returns
        ({(i, key): device tensor}, ready event)."""
        sources = self._host_sources(k)
        out = {}
        self.stats["bytes_in"] += sum(src.numel() * src.element_size() for src in sources.values())
        if not self.cuda:
            for ik, src in sources.items():
                out[ik] = src.clone()
            return out, None
        main = torch.cuda.current_stream(self.device)
        for ik, src in sources.items():
            out[ik] = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        self._h2d.wait_stream(main)  # the buffers' memory may still be read by queued work
        with torch.cuda.stream(self._h2d):
            for ik, src in sources.items():
                self.stats["pageable"] += not src.is_pinned()
                out[ik].copy_(src, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._h2d)
        return out, ready

    def _update(self, k: int, staged, mixed_update):
        """The optimizer's own step over group k's parameters alone, their
        state swapped in."""
        device_state, ready = staged
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        members = {id(self.params[i]) for i in self.groups[k]}
        for (i, key), t in device_state.items():
            p = self.params[i]
            self.optimizer.state[p][key] = _wrap_like(p, t)
        saved = [group["params"] for group in self.optimizer.param_groups]
        try:
            for group in self.optimizer.param_groups:
                group["params"] = [p for p in group["params"] if id(p) in members]
            with mixed_update():
                self.optimizer.step()
        finally:
            for group, params in zip(self.optimizer.param_groups, saved):
                group["params"] = params

    def _stage_out(self, k: int):
        """Group k's state copied back to its host buffers (on the copy-out
        stream, after the update); returns the copies' end event."""
        homes = self._homes(k)
        pairs = []
        for i in self.groups[k]:
            state = self.optimizer.state[self.params[i]]
            for key in self.keys:
                pairs.append(((i, key), _local(state[key]), homes[i, key]))
            self.initialized[i] = True
        done = None
        self.stats["bytes_out"] += sum(dev.numel() * dev.element_size() for _, dev, _ in pairs)
        if not self.cuda:
            for _, dev, host in pairs:
                host.copy_(dev)
        else:
            main = torch.cuda.current_stream(self.device)
            self._d2h.wait_stream(main)
            with torch.cuda.stream(self._d2h):
                for _, dev, host in pairs:
                    self.stats["pageable"] += not host.is_pinned()
                    host.copy_(dev, non_blocking=True)
                    dev.record_stream(self._d2h)
                done = torch.cuda.Event()
                done.record(self._d2h)
        self._release(k)
        return done

    def _homes(self, k: int) -> Dict[tuple, torch.Tensor]:
        """Group k's host buffers, by (i, key), that its state is copied
        back to."""
        raise NotImplementedError

    def _release(self, k: int):
        raise NotImplementedError

    def run(self, mixed_update=contextlib.nullcontext):
        """One chunked update over every group."""
        self.check_usable()
        self._streams()
        self._run(mixed_update)
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self._d2h)


class PinnedOptState(_OffloadedState):
    """The optimizer's per-parameter state in one pinned host arena (on
    the CPU a plain one): between steps each entry of `optimizer.state` is
    a view into it, so `optimizer.state_dict()` reads it in place."""

    tier = "pinned_host"

    def __init__(self, optimizer, device):
        super().__init__(optimizer, device)
        self.arena = HostArena([((i, key), shape, dtype) for i, key, shape, dtype in self.entries()], pin=self.cuda)

    def _host_sources(self, k):
        return {(i, key): self.arena.views[i, key] for i in self.groups[k] if self.initialized[i] for key in self.keys}

    def _homes(self, k):
        return {(i, key): self.arena.views[i, key] for i in self.groups[k] for key in self.keys}

    def _release(self, k):
        for i in self.groups[k]:
            state = self.optimizer.state[self.params[i]]
            for key in self.keys:
                state[key] = self.arena.views[i, key]

    def _run(self, mixed_update):
        staged = {0: self._stage_in(0)}
        for k in range(len(self.groups)):
            if k + 1 < len(self.groups):  # the next group's copy runs under this group's update
                staged[k + 1] = self._stage_in(k + 1)
            self._update(k, staged.pop(k), mixed_update)
            self._stage_out(k)

    def put(self, i: int, key: str, value: torch.Tensor):
        """Load one entry (a copy: the caller's tensor is not kept)."""
        self.synchronize()
        self.arena.views[i, key].copy_(value)
        self.optimizer.state[self.params[i]][key] = self.arena.views[i, key]

    def mark_loaded(self, loaded):
        for i in loaded:
            self.initialized[i] = True

    @contextlib.contextmanager
    def materialized(self):
        self.synchronize()
        yield


class DiskOptState(_OffloadedState):
    """The optimizer's per-parameter state in the disk store (JAX's NVMe
    tier): one blob under `directory`, an entry ``"<key>/<i>"`` per
    parameter `i` of the optimizer, rewritten in place each step; the
    scalar entries (step counts) stay in `optimizer.state`. Reads land in
    three pinned staging buffers in turn (on the CPU plain ones), the next
    group's read ahead of the current group's update; each group's
    write-back runs on one writer thread once its copy to the host is done.

    A step that fails after some groups were written back leaves the blob
    ahead of the parameters: the state is `poisoned` and the next step
    raises until `load` (a checkpoint's state) replaces it."""

    tier = "disk"
    STAGES = 3

    def __init__(self, optimizer, device, directory: str, owns_directory: bool = False):
        from .native import NativeOffloadStore

        super().__init__(optimizer, device)
        self.directory = directory
        # A temporary directory of its own goes with it.
        self._cleanup = weakref.finalize(self, shutil.rmtree, directory, True) if owns_directory else None
        self.store = NativeOffloadStore(directory)
        # A fresh state is a fresh blob: a previous run's would be kept and grown.
        self.store.reset()
        self.store.reserve([(self.name(i, key), shape, dtype) for i, key, shape, dtype in self.entries()])
        self.poisoned = False
        align = HostArena.ALIGN
        largest = max((sum(-(-_local(self.params[i]).numel() * torch.empty((), dtype=self._dtype(i, key)).element_size()
                             // align) * align for i in g for key in self.keys) for g in self.groups), default=0)
        # The arenas are kept: their views stay pinned only while they live.
        self._staging_arenas = [HostArena([("buffer", (max(largest, 1),), torch.uint8)], pin=self.cuda)
                                for _ in range(self.STAGES)]
        self._staging = [arena.views["buffer"] for arena in self._staging_arenas]
        self._writer = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="optstate-writeback")
        self._writes: Dict[int, concurrent.futures.Future] = {}

    @staticmethod
    def name(i: int, key: str) -> str:
        return f"{key}/{i}"

    def check_usable(self):
        if self.poisoned:
            raise RuntimeError(
                "disk optimizer state is inconsistent: a previous step failed after "
                "some parameter groups were written back. Restore with load_state() "
                "(or rebuild the optimizer) before continuing."
            )

    def _views(self, k: int) -> Dict[tuple, torch.Tensor]:
        """Group k's entries as views into its staging buffer."""
        buf, offset, out = self._staging[k % self.STAGES], 0, {}
        for i in self.groups[k]:
            shape = tuple(_local(self.params[i]).shape)
            for key in self.keys:
                dtype = self._dtype(i, key)
                numel = _local(self.params[i]).numel()
                size = numel * torch.empty((), dtype=dtype).element_size()
                out[i, key] = buf[offset:offset + size].view(dtype).view(shape)
                offset += -(-size // HostArena.ALIGN) * HostArena.ALIGN
        return out

    def _wait_stage(self, k: int):
        """Staging buffer k % STAGES is free once the write-back of the
        group that used it last is done."""
        fut = self._writes.pop(k - self.STAGES, None)
        if fut is not None:
            fut.result()

    def _readahead(self, k: int):
        views = self._views(k)
        names = [(self.name(i, key), t) for (i, key), t in views.items() if self.initialized[i]]
        if names:
            self.store.prefetch_many([n for n, _ in names], [t for _, t in names])

    def _host_sources(self, k):
        views = self._views(k)
        return {(i, key): self.store.read(self.name(i, key), out=t)
                for (i, key), t in views.items() if self.initialized[i]}

    def _homes(self, k):
        return self._views(k)

    def _release(self, k):
        for i in self.groups[k]:
            state = self.optimizer.state[self.params[i]]
            for key in self.keys:
                state.pop(key, None)

    def _write_group(self, k: int, done):
        if done is not None:
            done.synchronize()
        for (i, key), t in self._views(k).items():
            self.store.write(self.name(i, key), t)

    def _run(self, mixed_update):
        try:
            n = len(self.groups)
            self._wait_stage(0)
            self._readahead(0)
            for k in range(n):
                if k + 1 < n:  # group k+1's read runs under this group's update
                    self._wait_stage(k + 1)
                    self._readahead(k + 1)
                staged = self._stage_in(k)
                self._update(k, staged, mixed_update)
                done = self._stage_out(k)
                self._writes[k] = self._writer.submit(self._write_group, k, done)
            self._drain(raise_errors=True)
        except BaseException:
            # Some groups' write-backs may have landed while the parameters'
            # update is abandoned: the blob is ahead of them. Poison, so a
            # blind retry fails loudly (a load clears it).
            self._drain(raise_errors=False)
            self.poisoned = True
            raise

    def _drain(self, raise_errors: bool):
        writes, self._writes = self._writes, {}
        for fut in writes.values():
            try:
                fut.result()
            except Exception:
                if raise_errors:
                    raise

    def put(self, i: int, key: str, value: torch.Tensor):
        """Load one entry into the blob (the caller's tensor is not kept)."""
        self.store.write(self.name(i, key), value.detach().to("cpu"))

    def mark_loaded(self, loaded):
        for i in loaded:
            self.initialized[i] = True
        self.poisoned = False

    @contextlib.contextmanager
    def materialized(self):
        """Every initialized entry read into `optimizer.state` for the
        block (one pass over the blob), taken out again after."""
        for i, p in enumerate(self.params):
            if self.initialized[i]:
                for key in self.keys:
                    self.optimizer.state[p][key] = self.store.read(self.name(i, key))
        try:
            yield
        finally:
            for i, p in enumerate(self.params):
                for key in self.keys:
                    self.optimizer.state[p].pop(key, None)

    def close(self):
        """Finish the write-backs and close the store (a temporary
        directory of its own is removed)."""
        self._drain(raise_errors=False)
        self._writer.shutdown(wait=True)
        self.store.close()
        if self._cleanup is not None:
            self._cleanup()


class AcceleratedOptimizer:
    """A `torch.optim.Optimizer` bound to a prepared model, with the
    accelerator's `GradScaler` under fp16."""

    def __init__(self, optimizer: torch.optim.Optimizer, model=None, scaler: Optional[GradScaler] = None,
                 fsdp_plugin=None):
        self.optimizer = optimizer
        self.model = model
        self.layout = getattr(model, "layout", None)
        if self.layout is not None:
            self.layout.adopt(optimizer)
        #: The offload tier of the optimizer's state (`PinnedOptState` or
        #: `DiskOptState`), from the plugin as in JAX: the disk tier wins.
        self.offload = None
        if model is not None and fsdp_plugin is not None and (
                fsdp_plugin.offload_to_disk or fsdp_plugin.offload_optimizer_state):
            if optimizer.state:
                raise ValueError("prepare the optimizer before its first step: its state cannot be offloaded")
            if fsdp_plugin.offload_to_disk:
                directory = fsdp_plugin.offload_dir
                self.offload = DiskOptState(optimizer, model.device,
                                            directory or tempfile.mkdtemp(prefix="accelerate_tpu_torch_optstate_"),
                                            owns_directory=directory is None)
            else:
                self.offload = PinnedOptState(optimizer, model.device)
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
    def offload_opt_state(self) -> bool:
        """The optimizer's state lives off the card (JAX's attribute)."""
        return self.offload is not None

    def _apply_update(self):
        """The optimizer's update, resident or streamed group by group."""
        if self.offload is None:
            with self._mixed_update():
                self.optimizer.step()
            return
        try:
            self.offload.run(self._mixed_update)
        except BaseException:
            # As in JAX, the step's gradients are dropped: the next backward
            # starts fresh.
            self.optimizer.zero_grad(set_to_none=True)
            self._found_inf = None
            self._reduced = False
            raise

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
            self._apply_update()
            if self.layout is not None:
                self.layout.after_step()
        to_storage = getattr(self.model, "to_storage_memory", None)
        if to_storage is not None:
            to_storage(write=not skipped)
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
        processes). An offloaded state is read where it lives: the pinned
        arena's views, or the disk store in one pass."""
        with self.offload.materialized() if self.offload is not None else contextlib.nullcontext():
            state = (self.optimizer.state_dict() if self.layout is None
                     else self.layout.full_optimizer_state(self.optimizer))
            if self.offload is not None:  # torch packs the live per-parameter dicts
                state = {**state, "state": {i: dict(entry) for i, entry in state["state"].items()}}
            return state

    def state_shards(self):
        """(the state dict with None for each tensor, [(path, this process's
        tensor, whole shape, ``[[start, stop], ...]``)]) without a
        collective: under ZeRO-2 and FSDP a moment is this process's shard
        with its bounds in the whole moment, a step count whole; an
        offloaded state is read where it lives. A path is
        ``state/<index>/<key>``. The sharded checkpoint's entries."""
        with self.offload.materialized() if self.offload is not None else contextlib.nullcontext():
            state = self.optimizer.state_dict()
            names = None if self.layout is None else self.layout._optimizer_names(self.optimizer)
            skeleton, entries = {}, []
            for index, entry in state["state"].items():
                skeleton[index] = {}
                for key, value in entry.items():
                    if not torch.is_tensor(value):
                        skeleton[index][key] = value
                        continue
                    skeleton[index][key] = None
                    path = f"state/{index}/{key}"
                    if names is None or value.dim() == 0:
                        local = _local(value).detach()
                        entries.append((path, local, tuple(local.shape), [[0, int(d)] for d in local.shape]))
                    else:
                        name = names[index]
                        entries.append((path, *self.layout.local_entry(value, self.layout.shard_dims[name],
                                                                       self.layout.orig[name].shape)))
        return {"state": skeleton, "param_groups": copy.deepcopy(state["param_groups"])}, entries

    def load_state_dict(self, state: dict):
        """Load a whole state dict (from any layout), each process taking its
        shard. An offloaded state is copied into its tier (never onto the
        card whole, never keeping the caller's tensors) and a poisoned disk
        state is usable again."""
        if self.offload is None:
            if self.layout is None:
                self.optimizer.load_state_dict(state)
            else:
                self.layout.load_full_optimizer_state(self.optimizer, state)
            return
        keys = self.offload.keys
        light = {"state": {}, "param_groups": state["param_groups"]}
        entries = {}
        for index, entry in state["state"].items():
            light["state"][index] = {k: v for k, v in entry.items() if k not in keys}
            entries[int(index)] = {k: v for k, v in entry.items() if k in keys}
        if self.layout is None:
            self.optimizer.load_state_dict(light)
        else:
            self.layout.load_full_optimizer_state(self.optimizer, light)
        self.offload.initialized = [False] * len(self.offload.params)
        names = None if self.layout is None else self.layout._optimizer_names(self.optimizer)
        for i, values in entries.items():
            dim = None if names is None else self.layout.shard_dims[names[i]]
            for key, value in values.items():
                value = torch.as_tensor(value)
                if dim is not None:
                    value = self.layout.shard(value, dim).contiguous()
                self.offload.put(i, key, value)
        self.offload.mark_loaded([i for i, values in entries.items() if values])
