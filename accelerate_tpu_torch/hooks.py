"""Hooks on a module's forward (the port of `accelerate_tpu/hooks.py`).

JAX wraps a model bundle's `apply_fn`, whose parameters are an argument;
a torch module holds its parameters, so here a hook wraps the module's
`forward`, as the reference's hooks do: ``pre_forward(module, args,
kwargs)`` may move the module's tensors or change the arguments,
``post_forward(module, output)`` may change the output. `CpuOffload`
keeps a module's weights in host RAM between calls and brings them to
the execution device for each forward; chained through
`cpu_offload_with_hook`'s `prev_module_hook`, running a model first sends
its predecessor's weights home. `AlignDevicesHook` fills a module from a
weights map (an `OffloadedWeightsLoader`) for each forward and leaves meta
tensors in it between calls. Big-model inference itself streams layers
(`big_modeling`) instead of hooking modules.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from .device import DeviceLike, resolve_device


class ModelHook:
    """Base hook; override any stage."""

    def init_hook(self, module: nn.Module) -> nn.Module:
        """Called when attached; may return a changed module."""
        return module

    def pre_forward(self, module: nn.Module, args: tuple, kwargs: dict):
        """-> (args, kwargs) for the wrapped forward."""
        return args, kwargs

    def post_forward(self, module: nn.Module, output):
        """-> the output the caller sees."""
        return output

    def detach_hook(self, module: nn.Module) -> nn.Module:
        """Called when removed."""
        return module


class SequentialHook(ModelHook):
    """Several hooks, each stage run in order."""

    def __init__(self, *hooks: ModelHook):
        self.hooks = list(hooks)

    def init_hook(self, module):
        for hook in self.hooks:
            module = hook.init_hook(module)
        return module

    def pre_forward(self, module, args, kwargs):
        for hook in self.hooks:
            args, kwargs = hook.pre_forward(module, args, kwargs)
        return args, kwargs

    def post_forward(self, module, output):
        for hook in self.hooks:
            output = hook.post_forward(module, output)
        return output

    def detach_hook(self, module):
        for hook in self.hooks:
            module = hook.detach_hook(module)
        return module


def add_hook_to_module(module: nn.Module, hook: ModelHook, append: bool = False) -> nn.Module:
    """Wrap `module.forward` with `hook`; with `append`, the hook already
    there and this one run as one `SequentialHook`."""
    if append and getattr(module, "_atl_hook", None) is not None:
        hook = SequentialHook(module._atl_hook, hook)
        remove_hook_from_module(module)
    old_forward = module.forward
    module = hook.init_hook(module)

    def forward(*args, **kwargs):
        args, kwargs = hook.pre_forward(module, args, kwargs)
        return hook.post_forward(module, old_forward(*args, **kwargs))

    module._atl_hook = hook
    module._atl_old_forward = old_forward
    module.forward = forward
    return module


def remove_hook_from_module(module: nn.Module, recurse: bool = False) -> nn.Module:
    """Undo `add_hook_to_module` (on every submodule with `recurse`)."""
    hook = getattr(module, "_atl_hook", None)
    if hook is not None:
        hook.detach_hook(module)
        module.forward = module._atl_old_forward
        if module.forward == type(module).forward.__get__(module):
            del module.forward  # back to the class's own
        module._atl_hook = None
        module._atl_old_forward = None
    if recurse:
        for child in module.children():
            remove_hook_from_module(child, recurse=True)
    return module


class CpuOffload(ModelHook):
    """Weights in host RAM between calls, on `execution_device` (``cuda``
    by default) for the forward. With `prev_module_hook`, the forward first
    sends that model's weights home."""

    def __init__(self, execution_device: DeviceLike = None, prev_module_hook: Optional["UserCpuOffloadHook"] = None):
        self.execution_device = resolve_device(execution_device)
        self.prev_module_hook = prev_module_hook

    def init_hook(self, module):
        return module.to("cpu")

    def pre_forward(self, module, args, kwargs):
        if self.prev_module_hook is not None:
            self.prev_module_hook.offload()
        module.to(self.execution_device)
        return args, kwargs


class UserCpuOffloadHook:
    """A model and its `CpuOffload` hook: `offload` sends the weights
    home, `remove` detaches the hook."""

    def __init__(self, model: nn.Module, hook: CpuOffload):
        self.model = model
        self.hook = hook

    def offload(self):
        self.model.to("cpu")

    def remove(self):
        remove_hook_from_module(self.model)


def cpu_offload_with_hook(model: nn.Module, execution_device: DeviceLike = None,
                          prev_module_hook: Optional[UserCpuOffloadHook] = None):
    """Keep `model` in host RAM, on the device only for its forward;
    returns (model, its handle) for a pipeline of models run in turn."""
    hook = CpuOffload(execution_device=execution_device, prev_module_hook=prev_module_hook)
    model = add_hook_to_module(model, hook)
    return model, UserCpuOffloadHook(model, hook)


def _set_tensor(module: nn.Module, name: str, tensor: torch.Tensor):
    owner, _, pname = name.rpartition(".")
    setattr(module.get_submodule(owner) if owner else module, pname, nn.Parameter(tensor, requires_grad=False))


class AlignDevicesHook(ModelHook):
    """Fill the module from `weights_map` ({the module's parameter name:
    tensor}, e.g. an `OffloadedWeightsLoader`) on `execution_device` before
    the forward; with `offload`, leave meta tensors after it, so the weights
    are on the device only while the module runs. With `io_same_device`
    the output goes back to the first input's device."""

    def __init__(self, execution_device: DeviceLike = None, weights_map: Optional[Mapping] = None,
                 offload: bool = True, io_same_device: bool = False):
        self.execution_device = resolve_device(execution_device)
        self.weights_map = weights_map
        self.offload = offload
        self.io_same_device = io_same_device
        self._input_device = None

    def init_hook(self, module):
        if self.weights_map is not None and self.offload:
            self._release(module)
        return module

    def _release(self, module):
        for name in self.weights_map:
            t = self.weights_map[name]
            _set_tensor(module, name, torch.empty(t.shape, dtype=t.dtype, device="meta"))

    def pre_forward(self, module, args, kwargs):
        if self.weights_map is not None:
            for name in self.weights_map:
                _set_tensor(module, name, torch.as_tensor(self.weights_map[name]).to(self.execution_device))
        else:
            module.to(self.execution_device)
        first = next((a for a in args if isinstance(a, torch.Tensor)), None)
        self._input_device = None if first is None else first.device
        return args, kwargs

    def post_forward(self, module, output):
        if self.offload and self.weights_map is not None:
            self._release(module)
        if self.io_same_device and self._input_device is not None and isinstance(output, torch.Tensor):
            output = output.to(self._input_device)
        return output
