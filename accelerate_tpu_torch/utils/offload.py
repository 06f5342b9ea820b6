"""A folder of offloaded weights, a file a tensor (the port of
`accelerate_tpu/utils/offload.py`).

Each tensor is one ``.npy`` file (``a/b`` as ``a--b.npy``), bf16 stored as
its uint16 bit pattern (npy has no bf16), with an ``index.json`` of name ->
{filename, shape, dtype}: the JAX package's layout, so either package reads
the other's folder. `OffloadedWeightsLoader` is the lazy mapping over such
a folder and tensors held in memory that `hooks.AlignDevicesHook` reads.
A read maps the file copy-on-write: pages come in only when a tensor is
used.
"""

from __future__ import annotations

import json
import os
import weakref
from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch


def offload_weight(weight: torch.Tensor, weight_name: str, offload_folder: str, index: Optional[dict] = None) -> dict:
    """Write `weight` to ``<offload_folder>/<name>.npy`` and record it in
    `index` (returned)."""
    t = weight.detach().to("cpu").contiguous()
    dtype_name = str(t.dtype).replace("torch.", "")
    arr = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
    os.makedirs(offload_folder, exist_ok=True)
    fname = weight_name.replace("/", "--") + ".npy"
    np.save(os.path.join(offload_folder, fname), arr)
    if index is None:
        index = {}
    index[weight_name] = {"filename": fname, "shape": list(t.shape), "dtype": dtype_name}
    return index


def save_offload_index(index: dict, offload_folder: str):
    with open(os.path.join(offload_folder, "index.json"), "w") as f:
        json.dump(index, f, indent=2)


def load_offload_index(offload_folder: str) -> dict:
    path = os.path.join(offload_folder, "index.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_offloaded_weight(offload_folder: str, weight_info: dict) -> torch.Tensor:
    """One tensor of the folder, as a host tensor over a copy-on-write map of
    its file (bf16 restored from its uint16 bits)."""
    arr = np.load(os.path.join(offload_folder, weight_info["filename"]), mmap_mode="c")
    if weight_info["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class OffloadedWeightsLoader(Mapping):
    """Lazy mapping over tensors in memory (`state_dict`) and an offload
    folder (`save_folder` with its index); the memory side wins a name
    held in both."""

    def __init__(self, state_dict: Optional[Dict] = None, save_folder: Optional[str] = None,
                 index: Optional[dict] = None):
        if state_dict is None and save_folder is None:
            raise ValueError("Need either a state_dict or a save_folder")
        self.state_dict = state_dict or {}
        self.save_folder = save_folder
        if index is None and save_folder is not None:
            index = load_offload_index(save_folder)
        self.index = index or {}
        self.all_keys = list(self.state_dict.keys()) + [k for k in self.index if k not in self.state_dict]

    def __getitem__(self, key: str):
        if key in self.state_dict:
            return self.state_dict[key]
        return load_offloaded_weight(self.save_folder, self.index[key])

    def __iter__(self):
        return iter(self.all_keys)

    def __len__(self):
        return len(self.all_keys)


class PrefixedDataset(Mapping):
    """The entries of a mapping under ``prefix``, keyed without it."""

    def __init__(self, dataset: Mapping, prefix: str):
        self.dataset = dataset
        self.prefix = prefix

    def __getitem__(self, key):
        return self.dataset[f"{self.prefix}{key}"]

    def __iter__(self):
        return iter([key for key in self.dataset if key.startswith(self.prefix)])

    def __len__(self):
        return len([key for key in self.dataset if key.startswith(self.prefix)])


def extract_submodule_state(params, prefix: str) -> dict:
    """{flax path: tensor} of every parameter under a block prefix, from a
    module (through its flax view) or a mapping of flax paths."""
    from .modeling import _path_leaves

    return {path: leaf for path, leaf in _path_leaves(params) if path.startswith(prefix)}


def _unregister(buffer: torch.Tensor):
    torch.cuda.cudart().cudaHostUnregister(buffer.data_ptr())


class HostArena:
    """One block of host memory with tensor views into it: the training
    offload tiers' home for the f32 masters and the optimizer's state
    between steps. It is pinned once, whole, when `pin` (a run on the
    card): a plain host allocation of the exact size, registered with CUDA
    (`cudaHostRegister`) and unregistered when the arena goes; torch's
    caching host allocator would round it up to a power of two (48.4 GB
    to 64 GiB) and keep it after, and a copy from pageable memory would
    not be asynchronous. Views start on `ALIGN`-byte boundaries. The
    memory stays registered while the arena lives: a holder of its views
    keeps the arena too (a view outliving it reads pageable memory)."""

    ALIGN = 512

    def __init__(self, entries, pin: bool):
        """`entries`: (key, shape, dtype) in order; `views[key]` is each
        one's tensor."""
        offsets, total = [], 0
        for key, shape, dtype in entries:
            offsets.append(total)
            numel = 1
            for d in shape:
                numel *= int(d)
            total += -(-numel * torch.empty((), dtype=dtype).element_size() // self.ALIGN) * self.ALIGN
        self.nbytes = total
        self.pinned = bool(pin)
        self.buffer = torch.empty(max(total, 1), dtype=torch.uint8)
        if self.pinned:
            cudart = torch.cuda.cudart()
            rc = cudart.cudaHostRegister(self.buffer.data_ptr(), self.buffer.numel(), 0)
            if int(rc) != 0:
                raise RuntimeError(f"cudaHostRegister of {self.buffer.numel()} bytes failed with error {int(rc)}")
            # The finalizer holds the buffer: it is freed after it is unregistered.
            weakref.finalize(self, _unregister, self.buffer)
        self.views: Dict = {}
        for (key, shape, dtype), offset in zip(entries, offsets):
            numel = 1
            for d in shape:
                numel *= int(d)
            size = numel * torch.empty((), dtype=dtype).element_size()
            self.views[key] = self.buffer[offset:offset + size].view(dtype).view(tuple(shape))
