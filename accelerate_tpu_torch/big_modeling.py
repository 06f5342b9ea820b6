"""Big-model inference: models larger than the card, their weights across
the card, host RAM and disk (the port of `accelerate_tpu/big_modeling.py`).

A device map (`utils.modeling.infer_auto_device_map`) names a tier for each
block: a device index, "cpu" or "disk". `DispatchedModel` places every
parameter on its block's tier, cast to the compute dtype: on the card; in
host RAM, pinned when the model runs on the card; or in the disk store
(`native.NativeOffloadStore`, one blob read back by C++ threads). A model
with every block on one device runs its own forward. Otherwise, as in JAX,
the model runs as a layer stream through its family's `LayeredApply`: the
prelude (embeddings), each layer, the tail (final norm and head), while
the next layer's offloaded weights come to the card underneath the current
layer's compute.

On the card the stream is double-buffered. Two device slots take the
offloaded layers in turn; their copies run on a side CUDA stream, from
pinned host memory only (a copy from pageable memory would be
synchronous), and events order them: a slot is refilled only after the
compute that read it, and a layer computes only after its copy. A disk
layer is read (readahead tickets on the store's threads) into a pinned
staging slot of its own, which is reused only after its copy has left it.

Dispatch takes the model over, as the reference's hooks do: a parameter
placed off the device leaves the module (a meta tensor stands in), so the
card never holds the model twice.
"""

from __future__ import annotations

import contextlib
import logging
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn

from .device import DeviceLike, resolve_device
from .utils.modeling import (
    clean_device_map,
    flax_leaves,
    get_balanced_memory,
    get_max_memory,
    group_into_blocks,
    infer_auto_device_map,
)

logger = logging.getLogger(__name__)


class _DiskRef:
    """A disk-resident tensor: its name in the model's store, read when its
    block is fetched, so a streamed call reads only the layers it is about
    to run."""

    __slots__ = ("name", "shape", "dtype")

    def __init__(self, name: str, shape, dtype):
        self.name, self.shape, self.dtype = name, tuple(shape), dtype


def init_empty_weights(config_or_build, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """A model without storage: built on torch's meta device from a family
    config (or a zero-argument constructor), in `dtype` when given. Under
    `parallel.sharding.flax_view` its shapes and dtypes are those of JAX's
    `init_empty_weights` tree; it is what planning and
    `load_checkpoint_and_dispatch` start from."""
    if callable(config_or_build) and not hasattr(config_or_build, "__dataclass_fields__"):
        build = config_or_build
    else:
        from .models import MODULE_BY_CONFIG

        cls = MODULE_BY_CONFIG.get(type(config_or_build))
        if cls is None:
            raise ValueError(f"no model class for config {type(config_or_build).__name__}")
        build = lambda: cls(config_or_build)  # noqa: E731
    with torch.device("meta"):
        model = build()
    return model if dtype is None else model.to(dtype)


@contextlib.contextmanager
def init_on_device(device: DeviceLike):
    """Modules built inside are built on `device`."""
    with torch.device(resolve_device(device)):
        yield


class LayeredApply:
    """Layer-streamed execution of a model family: `split` cuts a model's
    parameters ({name: tensor}, the module's own names) into the prelude's,
    each layer's (named within the layer) and the tail's; the applies run
    each part on the tensors they are given. Every layer has the same
    names, shapes and code."""

    def split(self, params) -> tuple:
        """-> (prelude params, [layer params...], tail params)"""
        raise NotImplementedError

    def join(self, prelude, layers, tail):
        """The inverse of `split`."""
        raise NotImplementedError

    def apply_prelude(self, prelude_params, *args, **kwargs):
        raise NotImplementedError

    def apply_layer(self, layer_params, carry):
        raise NotImplementedError

    def apply_tail(self, tail_params, carry):
        raise NotImplementedError


class DispatchedModel:
    """A model whose parameter blocks live across the card, host RAM and
    disk per a device map (JAX's `DispatchedModel`); callable as the model
    is. With every block on one device it is the module's own forward;
    otherwise `layered` streams it.

    Tier 0 (a device index) is the execution device: ``cuda:i``, or the CPU
    when `device` is ``"cpu"`` (then "cpu" blocks are read in place and
    nothing is pinned). `transfer_stats` counts the host-to-device copies
    of the streamed path and their bytes, and how many came from pageable
    memory (0 on a correct run)."""

    def __init__(
        self,
        model,
        device_map: Dict[str, Union[int, str]],
        offload_folder: Optional[str] = None,
        layered: Optional[LayeredApply] = None,
        compute_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        module = getattr(model, "module", model)
        self.module = module
        self.layered = layered
        self.device_map = device_map
        self.offload_folder = offload_folder
        self.compute_dtype = compute_dtype
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.on_cuda = dev.type == "cuda"
        self.transfer_stats = {"copies": 0, "bytes": 0, "pageable": 0}
        self._slots: List[Dict[str, torch.Tensor]] = [{}, {}]  # device buffers of the streamed layers
        self._staging: List[Dict[str, torch.Tensor]] = [{}, {}, {}]  # pinned host buffers of their disk reads
        self._slot_ready: list = [None, None]  # each slot's last copy, ended
        self._stage_ready: list = [None, None, None]  # the last copy out of each staging buffer, ended
        self._side = torch.cuda.Stream(dev) if self.on_cuda else None
        self._guarded: set = set()

        path_of = {name: path for path, name, _, _ in flax_leaves(module)}
        block_of = {p: block for block, paths in group_into_blocks(module).items() for p in paths}
        self.tier_of: Dict[str, Union[int, str]] = {}
        self._leaves: Dict[str, Any] = OrderedDict()
        self._disk_store = None
        self._resident_devices = set()
        placed: Dict[int, tuple] = {}  # id(parameter) -> (placed value, the module's new parameter)
        for name, param in list(module.named_parameters(remove_duplicate=False)):
            tier = _lookup_tier(device_map, block_of[path_of[name]])
            self.tier_of[name] = tier
            if id(param) not in placed:  # a tied tensor is placed once
                value = self._place(name, param, tier)
                if isinstance(tier, str):  # off the device: a meta tensor stands in
                    value_param = torch.empty(param.shape, dtype=self._dtype(param.dtype), device="meta")
                else:
                    value_param = value
                placed[id(param)] = (value, nn.Parameter(value_param, requires_grad=False))
            self._leaves[name], new_param = placed[id(param)]
            owner, _, pname = name.rpartition(".")
            setattr(module.get_submodule(owner) if owner else module, pname, new_param)
            del param
        if self._disk_store is not None:
            self._disk_store.flush_index()
        self.hf_device_map = dict(device_map)

    # -- placement -----------------------------------------------------------------
    def _dtype(self, dtype: torch.dtype) -> torch.dtype:
        return self.compute_dtype if self.compute_dtype is not None and dtype.is_floating_point else dtype

    def _tier_device(self, tier) -> torch.device:
        return torch.device("cuda", int(tier)) if self.on_cuda else self.device

    def _place(self, name: str, param: torch.Tensor, tier):
        t = param.detach()
        dtype = self._dtype(t.dtype)
        if tier == "disk":
            if self.offload_folder is None:
                raise ValueError("device_map places blocks on disk; offload_folder is required")
            if self._disk_store is None:
                from .native import NativeOffloadStore

                self._disk_store = NativeOffloadStore(self.offload_folder)
                self._disk_store.reset()  # a previous run's blob would leak
            # One tensor at a time: host RAM never holds the spilled blocks at once.
            self._disk_store.save({name: t.to(dtype)}, flush_index=False)
            return _DiskRef(name, t.shape, dtype)
        if tier == "cpu":
            if not self.on_cuda:
                return t.to("cpu", dtype)
            host = torch.empty(t.shape, dtype=dtype, pin_memory=True)
            host.copy_(t)
            return host
        dev = self._tier_device(tier)
        self._resident_devices.add(dev)
        return t.to(dev, dtype)

    # -- leaf access ---------------------------------------------------------------
    def materialize_params(self, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """Every parameter, by the module's names, on `device` (the
        execution device by default): for a model that fits transiently;
        the streamed path never does this."""
        dev = self.device if device is None else resolve_device(device)
        if self._disk_store is not None:
            self._disk_store.prefetch_many([v.name for v in self._leaves.values() if isinstance(v, _DiskRef)])
        out, fetched = {}, {}
        for name, leaf in self._leaves.items():
            if id(leaf) not in fetched:
                fetched[id(leaf)] = (self._disk_store.read(leaf.name) if isinstance(leaf, _DiskRef) else leaf).to(dev)
            out[name] = fetched[id(leaf)]
        return out

    @property
    def resident_fraction(self) -> float:
        """Share of the parameters (by count) placed on a device."""
        n_dev = sum(1 for t in self.tier_of.values() if not isinstance(t, str))
        return n_dev / max(1, len(self.tier_of))

    # -- execution -----------------------------------------------------------------
    @torch.no_grad()
    def __call__(self, *args, **kwargs):
        all_resident = all(not isinstance(t, str) for t in self.tier_of.values())
        if all_resident and len(self._resident_devices) <= 1:
            return self.module(*args, **kwargs)
        if self.layered is not None:
            return self._streamed_call(*args, **kwargs)
        logger.warning("model has offloaded blocks but no LayeredApply; materializing every parameter per call")
        return torch.func.functional_call(self.module, self.materialize_params(), args, kwargs)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32, eos_token_id: Optional[int] = None,
                 attention_mask=None):
        """Greedy generation through the tiered forward (JAX's
        `DispatchedModel.generate`, the reference's big-model-inference
        benchmark shape): each token runs the whole model again over the
        context, re-streaming the offloaded layers, with no cache.

        The forward covers the context bucketed to a power of two (padding
        after a row's last real token is invisible under causal masking).
        `attention_mask` (right-padded) lets prompts of unequal length
        share a batch: each row reads its next token at its own frontier
        and writes it over its first pad. With `eos_token_id` a finished row
        emits EOS and the loop stops once every row has finished. Returns
        [B, max(prompt + steps, prompt_len)] ids, right-padded with 0."""
        from .generation import _bucket_for

        ids = torch.as_tensor(input_ids).to(self.device, torch.int64).clone()
        b, prompt_len = ids.shape
        if attention_mask is not None:
            am = torch.as_tensor(attention_mask).to(self.device).bool()
            lengths = am.sum(dim=1)
            prefix = torch.arange(prompt_len, device=self.device)[None, :] < lengths[:, None]
            if not bool(torch.equal(am, prefix)) or not bool((lengths >= 1).all()):
                raise ValueError(
                    "attention_mask must be right-padded (each row a non-empty prefix of ones); "
                    "re-tokenize with padding_side='right'"
                )
            ids = torch.where(am, ids, 0)  # pad slots are overwritten
            max_len = int(lengths.max())
        else:
            lengths = torch.full((b,), prompt_len, dtype=torch.int64, device=self.device)
            max_len = prompt_len
        cur = lengths.clone()
        rows = torch.arange(b, device=self.device)
        finished = torch.zeros(b, dtype=torch.bool, device=self.device)
        buf, steps_taken = ids, 0
        for step in range(max_new_tokens):
            bucket = _bucket_for(max_len + step)
            if buf.shape[1] < bucket + 1:  # +1: room for this step's frontier write
                buf = torch.nn.functional.pad(buf, (0, bucket + 1 - buf.shape[1]))
            logits = self(buf[:, :bucket])
            nxt = logits[rows, cur - 1, :].argmax(dim=-1)
            if eos_token_id is not None:
                nxt = torch.where(finished, torch.full_like(nxt, eos_token_id), nxt)
                finished = finished | (nxt == eos_token_id)
            buf[rows, cur] = nxt
            cur = cur + 1
            steps_taken = step + 1
            if eos_token_id is not None and bool(finished.all()):
                break
        return buf[:, : max(max_len + steps_taken, prompt_len)]

    # -- the stream ----------------------------------------------------------------
    def _count(self, src: torch.Tensor):
        self.transfer_stats["copies"] += 1
        self.transfer_stats["bytes"] += src.numel() * src.element_size()
        if not src.is_pinned():
            self.transfer_stats["pageable"] += 1

    def _to_device(self, leaf) -> torch.Tensor:
        """One leaf on the execution device, on the current stream (the
        prelude's and the tail's, outside the double buffer)."""
        if isinstance(leaf, _DiskRef):
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=self.on_cuda)
            leaf = self._disk_store.read(leaf.name, out=host)
        if leaf.device == self.device or not self.on_cuda:
            return leaf
        if leaf.device.type == "cpu":
            self._count(leaf)
        return leaf.to(self.device, non_blocking=True)

    def _fetch(self, group: dict, fetched: dict) -> dict:
        out = {}
        for k, leaf in group.items():
            if id(leaf) not in fetched:
                fetched[id(leaf)] = self._to_device(leaf)
            out[k] = fetched[id(leaf)]
        return out

    def _buffer(self, store: List[dict], s: int, key: str, leaf, pinned: bool = False) -> torch.Tensor:
        t = store[s].get(key)
        if t is None or t.shape != tuple(leaf.shape) or t.dtype != leaf.dtype:
            if pinned:
                t = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            else:
                t = torch.empty(leaf.shape, dtype=leaf.dtype, device=self.device)
            store[s][key] = t
        return t

    def _in_place(self, leaf) -> bool:
        """Whether a layer can read `leaf` where it is: on the execution
        device, or in host RAM when the model runs on the CPU."""
        return not isinstance(leaf, _DiskRef) and (leaf.device == self.device or not self.on_cuda)

    def _readahead(self, group: dict, slot: int, stage: int):
        """Start reading a layer's disk tensors: into pinned staging buffer
        `stage` on the card (after the copy that last read it has ended),
        into device slot `slot` on the CPU."""
        disk = [(k, v) for k, v in group.items() if isinstance(v, _DiskRef)]
        if not disk:
            return
        if self.on_cuda and self._stage_ready[stage] is not None:
            self._stage_ready[stage].synchronize()
        outs = [self._buffer(self._staging, stage, k, v, pinned=True) if self.on_cuda
                else self._buffer(self._slots, slot, k, v) for k, v in disk]
        self._disk_store.prefetch_many([v.name for _, v in disk], outs)

    def _issue(self, group: dict, slot: int, stage: int, free: list) -> dict:
        """Bring one layer into device slot `slot`: host and disk tensors
        copied on the side stream once the compute that last read the slot
        is done (`free[slot]`); `_slot_ready[slot]` marks the copies' end."""
        out = {}
        if not self.on_cuda:
            for k, leaf in group.items():
                if isinstance(leaf, _DiskRef):
                    leaf = self._disk_store.read(leaf.name, out=self._buffer(self._slots, slot, k, leaf))
                out[k] = leaf
            return out
        host = {k: (self._disk_store.read(v.name, out=self._buffer(self._staging, stage, k, v, pinned=True))
                    if isinstance(v, _DiskRef) else v) for k, v in group.items()}
        main = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._side):
            if free[slot] is not None:
                self._side.wait_event(free[slot])
            for k, src in host.items():
                if src.device == self.device:
                    out[k] = src
                    continue
                dst = self._buffer(self._slots, slot, k, src)
                if dst.data_ptr() not in self._guarded:
                    dst.record_stream(main)  # freed only after the compute that reads it
                    self._guarded.add(dst.data_ptr())
                self._count(src)
                dst.copy_(src, non_blocking=True)
                out[k] = dst
            ready = torch.cuda.Event()
            ready.record(self._side)
        self._slot_ready[slot] = self._stage_ready[stage] = ready
        return out

    def _streamed_call(self, *args, **kwargs):
        """Prelude, the layers, tail (JAX's `_streamed_call`). The layers a
        copy brings in take the two device slots in turn; the copy of the
        k-th such layer is issued as soon as the compute of the (k-2)-th is
        enqueued, so it runs under every layer computed in between, resident
        ones included. Disk reads start one such layer earlier still, into
        three pinned staging buffers in turn."""
        prelude_p, layer_ps, tail_p = self.layered.split(self._leaves)
        fetched: dict = {}  # the tail reads the prelude's copy of a tied tensor
        carry = self.layered.apply_prelude(self._fetch(prelude_p, fetched), *args, **kwargs)
        moved = [i for i, group in enumerate(layer_ps) if not all(self._in_place(v) for v in group.values())]
        order = {i: k for k, i in enumerate(moved)}
        stages = len(self._staging) if self.on_cuda else 2
        free: list = [None, None]
        main = torch.cuda.current_stream(self.device) if self.on_cuda else None
        if self.on_cuda:
            # The slots may still be read by an earlier call's compute.
            self._side.wait_stream(main)
        pending = {}
        for k in range(min(3 if self.on_cuda else 2, len(moved))):
            self._readahead(layer_ps[moved[k]], k % 2, k % stages)
        for k in range(min(2, len(moved))):
            pending[moved[k]] = self._issue(layer_ps[moved[k]], k % 2, k % stages, free)
        for i, group in enumerate(layer_ps):
            if i not in order:
                carry = self.layered.apply_layer(group, carry)
                continue
            k = order[i]
            slot = k % 2
            if self.on_cuda:
                main.wait_event(self._slot_ready[slot])
            carry = self.layered.apply_layer(pending.pop(i), carry)
            if self.on_cuda:
                free[slot] = torch.cuda.Event()
                free[slot].record(main)
            if k + 2 < len(moved):
                if not self.on_cuda:  # the slot's own buffers take the read
                    self._readahead(layer_ps[moved[k + 2]], slot, slot)
                pending[moved[k + 2]] = self._issue(layer_ps[moved[k + 2]], slot, (k + 2) % stages, free)
            if self.on_cuda and k + 3 < len(moved):
                self._readahead(layer_ps[moved[k + 3]], (k + 3) % 2, (k + 3) % stages)
        return self.layered.apply_tail(self._fetch(tail_p, fetched), carry)


def _lookup_tier(device_map: dict, block_name: str):
    if block_name in device_map:
        return device_map[block_name]
    parts = block_name.split("/")
    for i in range(len(parts), -1, -1):
        prefix = "/".join(parts[:i])
        if prefix in device_map:
            return device_map[prefix]
    return 0


def dispatch_model(model, device_map: Dict[str, Union[int, str]], offload_folder: Optional[str] = None,
                   layered: Optional[LayeredApply] = None, dtype: Optional[torch.dtype] = None,
                   device: DeviceLike = None) -> DispatchedModel:
    """Place a model with weights across the tiers of `device_map`."""
    if isinstance(device_map, str):
        raise ValueError("Pass a concrete device_map dict; use load_checkpoint_and_dispatch for 'auto'")
    return DispatchedModel(model, clean_device_map(device_map), offload_folder=offload_folder, layered=layered,
                           compute_dtype=dtype, device=device)


def cpu_offload(model, layered: Optional[LayeredApply] = None, device: DeviceLike = None) -> DispatchedModel:
    """Every parameter in host RAM, streamed a layer at a time."""
    return DispatchedModel(model, {"": "cpu"}, layered=layered, device=device)


def disk_offload(model, offload_dir: str, layered: Optional[LayeredApply] = None,
                 device: DeviceLike = None) -> DispatchedModel:
    """Every parameter in the disk store under `offload_dir`."""
    return DispatchedModel(model, {"": "disk"}, offload_folder=offload_dir, layered=layered, device=device)


def load_checkpoint_and_dispatch(
    model,
    checkpoint: Optional[str] = None,
    device_map: Union[str, dict, None] = "auto",
    max_memory: Optional[dict] = None,
    no_split_prefixes: Optional[List[str]] = None,
    offload_folder: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    layered: Optional[LayeredApply] = None,
    device: DeviceLike = None,
) -> DispatchedModel:
    """Budgets, device map, load, dispatch in one call.

    `checkpoint` is a directory the port's `save_model` wrote (one
    safetensors file, or shards and their index), read through
    `checkpointing.load_model_safetensors` (a private memory map: nothing
    is copied until a tier takes it). JAX's reads its own `save_pytree`
    files, whose manifest pickles a JAX tree structure; the port reads what
    the port writes. `model` may be empty (`init_empty_weights`): its
    tensors are then the checkpoint's. `device_map` "auto"/"balanced"
    evens the device budgets first; "sequential" fills device 0 first."""
    module = getattr(model, "module", model)
    if checkpoint is not None:
        from .checkpointing import load_model_safetensors

        module.load_state_dict(load_model_safetensors(checkpoint), strict=True, assign=True)
    if device_map in ("auto", "balanced"):
        budgets = get_balanced_memory(module, max_memory, dtype=dtype)
        device_map = infer_auto_device_map(module, budgets, no_split_prefixes=no_split_prefixes, dtype=dtype)
    elif device_map == "sequential":
        device_map = infer_auto_device_map(module, get_max_memory(max_memory), no_split_prefixes=no_split_prefixes,
                                           dtype=dtype)
    logger.info("device_map tiers: %s", dict(list(device_map.items())[:8]))
    return dispatch_model(module, device_map, offload_folder=offload_folder, layered=layered, dtype=dtype,
                          device=device)
