"""Process-wide training state (the one-process part of `accelerate_tpu/state.py`).

`AcceleratorState` holds the device and the precision mode; `GradientState`
the accumulation bookkeeping that the accelerator, the optimizers, the
schedulers and the data loaders share. Both are Borg singletons, as in the
JAX package: every instance reads and writes one shared dict, so an
optimizer built inside `prepare` sees the `sync_gradients` flag the
accelerator sets. Tests reset them with `_reset_state()`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .device import resolve_device
from .utils.dataclasses import COMPUTE_DTYPES, GradientAccumulationPlugin, PrecisionType


class AcceleratorState:
    """Device and mixed-precision mode of this process."""

    _shared_state: dict = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False):
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
        mode = mode or "no"
        if mode not in PrecisionType.list():
            raise ValueError(f"mixed_precision must be one of {PrecisionType.list()}, got {mode}")
        # The card unless the caller asks for the CPU; no card raises.
        self.device = resolve_device("cpu" if cpu else None)
        self._mixed_precision = mode

    @property
    def initialized(self) -> bool:
        return bool(self._shared_state)

    @staticmethod
    def _reset_state():
        AcceleratorState._shared_state.clear()

    @property
    def mixed_precision(self) -> str:
        return self._mixed_precision

    @property
    def compute_dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self._mixed_precision]


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
