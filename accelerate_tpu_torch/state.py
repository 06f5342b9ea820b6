"""Process-wide training state (the port of `accelerate_tpu/state.py`).

`PartialState` holds the processes: one per card, joined by
`torch.distributed` when the launcher says so (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as torchrun and
`launchers.debug_launcher` set them). On the card the group's backend is
NCCL, each process bound to its ``LOCAL_RANK``'s device; under ``cpu=True``
(or ``ACCELERATE_TPU_USE_CPU=1``) it is gloo. Without those variables
there is no group and one process. `InitProcessGroupKwargs`' `timeout`,
`backend` and `init_method` reach `init_process_group` through the
`Accelerator` (the keyword arguments of the first `PartialState`).
`PartialState.debug` comes from
``ACCELERATE_TPU_DEBUG_MODE``: the collectives of `utils.operations` then
compare their inputs' shapes across the processes first, as JAX's do.
`AcceleratorState` adds the precision
mode (the argument, else ``ACCELERATE_TPU_MIXED_PRECISION`` as the launcher
sets it, else "no"), the `ParallelismConfig`, the FSDP plugin and the ("data", "fsdp")
`DeviceMesh`; `GradientState` the accumulation bookkeeping that the
accelerator, the optimizers, the schedulers and the data loaders share.
All three are Borg singletons, as in the JAX package: every instance reads
and writes one shared dict, so an optimizer built inside `prepare` sees
the `sync_gradients` flag the accelerator sets. Tests reset them with
`_reset_state()`. Importing this module creates no process group; a group
`PartialState` creates is torn down at the interpreter's exit if the
script has not done so.
"""

from __future__ import annotations

import atexit
import datetime
import os
import sys
from contextlib import contextmanager
from functools import partial, wraps
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .device import resolve_device
from .utils.dataclasses import (
    COMPUTE_DTYPES,
    DistributedType,
    GradientAccumulationPlugin,
    ParallelismConfig,
    PrecisionType,
    parse_flag_from_env,
)

#: The launcher's variables that make this process one of a group.
_LAUNCH_ENV = ("RANK", "WORLD_SIZE")


def gloo_card(local_rank: int, share_device: bool = False) -> torch.device:
    """The card of a rank of a gloo group on the card: ``cuda:LOCAL_RANK``,
    as under NCCL. Ranks past the host's card count share its cards
    (``LOCAL_RANK`` modulo the count) only with `share_device`: NCCL takes
    one rank a device, so ranks that share one run gloo, each collective
    staged through the host. Without a card this raises."""
    count = torch.cuda.device_count()
    if count and local_rank >= count and not share_device:
        raise RuntimeError(
            f"a gloo rank with LOCAL_RANK {local_rank} on a host with {count} card(s): pass share_device=True "
            "to put ranks on a shared card, or cpu=True for the CPU path")
    device = resolve_device(torch.device("cuda", local_rank % max(count, 1)))
    torch.cuda.set_device(device)
    return device


#: How long a rank at its exit waits for every rank of its group to be
#: exiting too, before it leaves the group as it is.
EXIT_WAIT_S = 5.0
_EXITING_KEY = "accelerate_tpu_torch/exiting"
#: The statuses `sys.exit` was called with in this process, once
#: `_record_exit_statuses` has wrapped it (Python tells an exit handler
#: nothing of the status).
_EXIT_STATUSES: list = []


def _record_exit_statuses():
    """Wrap `sys.exit` (once) so that it keeps its status in `_EXIT_STATUSES`."""
    exit_ = sys.exit
    if getattr(exit_, "records_status", False):
        return

    def recording_exit(status=None):
        _EXIT_STATUSES.append(status)
        exit_(status)

    recording_exit.records_status = True
    sys.exit = recording_exit


def _destroy_group_at_exit():
    """Tear down the process group before the interpreter's own teardown,
    once every rank is exiting: a gloo group left to it can abort a process
    whose work is done ("terminate called without an active exception",
    SIGABRT, in a few launches in a hundred under load on the CPU), since
    its threads still run while the interpreter's statics are destroyed.
    A rank that fails (an uncaught exception, a `sys.exit` status other
    than 0, or no peer exiting within `EXIT_WAIT_S`) leaves the group as
    it is: its peers see it gone only when its process is, so a launcher
    reports its status, not theirs."""
    if not (dist.is_available() and dist.is_initialized()) or getattr(sys, "last_exc", None) is not None:
        return
    if _EXIT_STATUSES and _EXIT_STATUSES[-1] not in (None, 0):
        return
    try:
        store = dist.distributed_c10d._get_default_store()
        store.set_timeout(datetime.timedelta(seconds=EXIT_WAIT_S))
        if store.add(_EXITING_KEY, 1) == dist.get_world_size():
            store.set(_EXITING_KEY + "/all", "1")
        store.wait([_EXITING_KEY + "/all"], datetime.timedelta(seconds=EXIT_WAIT_S))
    except Exception:  # a peer not exiting, or the store gone with it
        return
    dist.destroy_process_group()


class PartialState:
    """The processes of this run and their control primitives (JAX's
    `PartialState`, over `torch.distributed`).

    Attributes: `device` (this process's card, or the CPU), `backend`
    ("nccl", "gloo" or None without a group), `distributed_type`,
    `num_processes`, `process_index`, `local_process_index`, and `debug`
    (``ACCELERATE_TPU_DEBUG_MODE``: collectives verify shapes first).
    Under gloo on the card each rank takes ``cuda:LOCAL_RANK`` (`gloo_card`;
    ``share_device=True`` lets ranks share a card)."""

    _shared_state: dict = {}

    def __init__(self, cpu: bool = False, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        self.debug = parse_flag_from_env("ACCELERATE_TPU_DEBUG_MODE")
        cpu = bool(cpu) or parse_flag_from_env("ACCELERATE_TPU_USE_CPU")
        env = os.environ
        launched = all(k in env for k in _LAUNCH_ENV)
        if dist.is_available() and dist.is_initialized():
            backend = dist.get_backend()
        elif launched:
            backend = kwargs.get("backend") or ("gloo" if cpu else "nccl")
        else:
            backend = None
        self.local_process_index = int(env.get("LOCAL_RANK", 0))
        if backend is None:
            # One process: the card when there is one (`AcceleratorState`
            # resolves, and refuses, its own device).
            self.device = torch.device("cuda" if not cpu and torch.cuda.is_available() else "cpu")
        elif backend == "gloo":
            self.device = torch.device("cpu") if cpu else gloo_card(self.local_process_index,
                                                                     bool(kwargs.get("share_device")))
        elif backend == "nccl":
            self.device = resolve_device(torch.device("cuda", self.local_process_index))
            torch.cuda.set_device(self.device)
        else:
            raise RuntimeError(f"unsupported process-group backend {backend!r}: the port runs nccl or gloo")
        if backend is not None and not dist.is_initialized():
            timeout = kwargs.get("timeout")
            extra = {"timeout": timeout} if timeout is not None else {}
            if backend == "nccl":
                extra["device_id"] = self.device
            dist.init_process_group(backend, init_method=kwargs.get("init_method") or "env://",
                                    rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]), **extra)
            atexit.unregister(_destroy_group_at_exit)  # once, however many groups this process makes
            atexit.register(_destroy_group_at_exit)
            _record_exit_statuses()
        self.backend = backend
        self.cpu = self.device.type == "cpu"
        self.num_processes = dist.get_world_size() if backend else 1
        self.process_index = dist.get_rank() if backend else 0
        self.distributed_type = DistributedType.MULTI_HOST if self.num_processes > 1 else DistributedType.NO

    def __repr__(self) -> str:
        return (
            f"Distributed environment: {self.distributed_type}\n"
            f"Backend: {self.backend}\n"
            f"Num processes: {self.num_processes}\n"
            f"Process index: {self.process_index}\n"
            f"Local process index: {self.local_process_index}\n"
            f"Device: {self.device}\n"
        )

    @staticmethod
    def _reset_state():
        """Forget the singleton (tests); the process group, if any, stays."""
        PartialState._shared_state.clear()

    @property
    def initialized(self) -> bool:
        return self._shared_state != {}

    @property
    def use_distributed(self) -> bool:
        """True when this process belongs to a process group (at any size)."""
        return self.backend is not None

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def wait_for_everyone(self):
        """A barrier over every process; nothing without a group."""
        if self.use_distributed:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    @contextmanager
    def main_process_first(self):
        """The main process runs the body before the others."""
        if not self.is_main_process:
            self.wait_for_everyone()
        yield
        if self.is_main_process:
            self.wait_for_everyone()

    @contextmanager
    def local_main_process_first(self):
        """The local main process of each node runs the body before the
        others there."""
        if not self.is_local_main_process:
            self.wait_for_everyone()
        yield
        if self.is_local_main_process:
            self.wait_for_everyone()

    def on_main_process(self, function: Callable = None):
        """Decorator: run `function` on the main process only."""
        if not self.initialized:
            raise ValueError("The `PartialState` must be initialized before calling this")

        @wraps(function)
        def _inner(*args, **kwargs):
            if self.is_main_process:
                return function(*args, **kwargs)

        return _inner

    def on_local_main_process(self, function: Callable = None):
        """Decorator: run `function` on each node's local main process only."""

        @wraps(function)
        def _inner(*args, **kwargs):
            if self.is_local_main_process:
                return function(*args, **kwargs)

        return _inner

    def on_last_process(self, function: Callable):
        """Decorator: run `function` on the last process only."""

        @wraps(function)
        def _inner(*args, **kwargs):
            if self.is_last_process:
                return function(*args, **kwargs)

        return _inner

    def on_process(self, function: Callable = None, process_index: int = None):
        if function is None:
            return partial(self.on_process, process_index=process_index)

        @wraps(function)
        def _inner(*args, **kwargs):
            if self.process_index == process_index:
                return function(*args, **kwargs)

        return _inner

    def print(self, *args, **kwargs):
        """`print` on the main process only."""
        if self.is_main_process:
            print(*args, **kwargs)

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's contiguous share of `inputs` (a list, tuple, numpy
        array, tensor, or a dict of those, nested): the first
        ``len % num_processes`` processes take one more. With
        `apply_padding` the last element repeats so every process takes the
        same count (cut again by `gather_for_metrics`). The values of a
        dict must all have one length."""
        if self.num_processes == 1:
            yield inputs
            return

        def _split(obj):
            length = len(obj)
            per_process, extras = divmod(length, self.num_processes)
            start = self.process_index * per_process + min(self.process_index, extras)
            end = start + per_process + (1 if self.process_index < extras else 0)
            result = obj[start:end]
            if apply_padding:
                target = per_process + (1 if extras > 0 else 0)
                while len(result) < target:
                    if isinstance(result, torch.Tensor):
                        result = torch.cat([result, result[-1:]], dim=0)
                    elif isinstance(result, np.ndarray):
                        result = np.concatenate([result, result[-1:]], axis=0)
                    else:
                        result = list(result) + list(result[-1:])
            return result

        def _leaf_lengths(obj):
            if isinstance(obj, dict):
                return [n for v in obj.values() for n in _leaf_lengths(v)]
            return [len(obj)]

        def _split_values(obj):
            if isinstance(obj, dict):
                return {k: _split_values(v) for k, v in obj.items()}
            return _split(obj)

        if isinstance(inputs, dict) and len(set(_leaf_lengths(inputs))) > 1:
            raise ValueError("All values in a dict passed to `split_between_processes` must be equal length")
        yield _split_values(inputs)

    def destroy_process_group(self):
        """Tear down the process group and forget the singleton."""
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        self._reset_state()


class AcceleratorState:
    """Precision mode, parallelism and the FSDP plugin over `PartialState`;
    a `DeepSpeedPlugin` lowers to the FSDP plugin and a `MegatronLMPlugin`
    to the parallelism config, as in JAX."""

    _shared_state: dict = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False,
                 parallelism_config: Optional[ParallelismConfig] = None, fsdp_plugin=None, deepspeed_plugin=None,
                 megatron_lm_plugin=None, **kwargs):
        if megatron_lm_plugin is not None and parallelism_config is None:
            # A Megatron degree the port's mesh does not run raises, with or
            # without a process group, before the singleton is touched.
            from .parallel.mesh import refuse_waiting_axes

            refuse_waiting_axes(megatron_lm_plugin.to_parallelism_config().axis_sizes())
        self.__dict__ = self._shared_state
        mode = None if mixed_precision is None else str(mixed_precision).lower()
        if self.initialized:
            if mode is not None and mode != self._mixed_precision:
                raise ValueError(
                    f"AcceleratorState already initialized with mixed_precision="
                    f"{self._mixed_precision}; cannot re-init with {mode}. "
                    "Call AcceleratorState._reset_state() first (tests) or pass the value once."
                )
            return
        mode = mode or str(os.environ.get("ACCELERATE_TPU_MIXED_PRECISION") or "no").lower()
        if mode not in PrecisionType.list():
            raise ValueError(f"mixed_precision must be one of {PrecisionType.list()}, got {mode}")
        self._partial = PartialState(cpu, **kwargs)
        # The card unless the caller asks for the CPU; no card raises. In a
        # process group, the group's device.
        if self._partial.use_distributed:
            self.device = self._partial.device
        else:
            self.device = resolve_device("cpu" if cpu or parse_flag_from_env("ACCELERATE_TPU_USE_CPU") else None)
        self._mixed_precision = mode
        # The compatibility plugins lower to the mesh and the FSDP plugin, as
        # in JAX.
        if megatron_lm_plugin is not None and parallelism_config is None:
            parallelism_config = megatron_lm_plugin.to_parallelism_config()
        if deepspeed_plugin is not None and fsdp_plugin is None:
            fsdp_plugin = deepspeed_plugin.to_fsdp_plugin()
        self.parallelism_config = parallelism_config or ParallelismConfig.from_env()
        self.fsdp_plugin = fsdp_plugin
        self.deepspeed_plugin = deepspeed_plugin
        self.megatron_lm_plugin = megatron_lm_plugin
        self._mesh = None

    def __getattr__(self, name):
        # Only reached when normal lookup fails: the process attributes.
        if name in ("_partial", "__dict__"):
            raise AttributeError(name)
        partial_state = self.__dict__.get("_partial")
        if partial_state is not None and hasattr(partial_state, name):
            return getattr(partial_state, name)
        raise AttributeError(f"`AcceleratorState` object has no attribute `{name}`")

    @property
    def initialized(self) -> bool:
        return bool(self._shared_state)

    @staticmethod
    def _reset_state(reset_partial_state: bool = False):
        AcceleratorState._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()

    @property
    def mixed_precision(self) -> str:
        return self._mixed_precision

    @property
    def compute_dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self._mixed_precision]

    @property
    def use_fsdp(self) -> bool:
        return self.fsdp_plugin is not None

    @property
    def mesh(self):
        """The ("data", "fsdp") `DeviceMesh` of the process group, built on
        first use from `parallelism_config`; None without a group."""
        if self._mesh is None and self._partial.use_distributed:
            from .parallel.mesh import build_mesh

            self._mesh = build_mesh(self.parallelism_config)
        return self._mesh

    def wait_for_everyone(self):
        self._partial.wait_for_everyone()


class GradientState:
    """Gradient-accumulation bookkeeping shared by the training objects.

      - `sync_gradients`: True on a step boundary (apply the update), set by
        `Accelerator.accumulate` and by every fused train step, or forced by
        the end of the active data loader.
      - `end_of_dataloader`: read from the active prepared loader.
    """

    _shared_state: dict = {}

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references = [None]
            self.plugin_kwargs = {}
        if gradient_accumulation_plugin is not None:
            self.plugin_kwargs = gradient_accumulation_plugin.to_kwargs()

    @property
    def initialized(self) -> bool:
        return bool(GradientState._shared_state)

    @property
    def num_steps(self) -> int:
        return self.plugin_kwargs.get("num_steps", 1)

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin_kwargs.get("sync_with_dataloader", True)

    @property
    def end_of_dataloader(self) -> bool:
        return self.active_dataloader is not None and self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        """The global count of the active loader's last batch when it was
        padded to a full one (`gather_for_metrics` keeps that many rows of
        it); -1 outside a loader or when nothing was padded."""
        if self.active_dataloader is None:
            return -1
        return getattr(self.active_dataloader, "remainder", -1)

    def _set_sync_gradients(self, sync_gradients: bool):
        self.sync_gradients = sync_gradients

    def _add_dataloader(self, dataloader):
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader):
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = self.dataloader_references[-1]

    @staticmethod
    def _reset_state():
        GradientState._shared_state.clear()
