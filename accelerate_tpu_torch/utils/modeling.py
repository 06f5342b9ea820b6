"""The safetensors file format, read and written with torch alone.

Port of `load_safetensors_state_dict` (`accelerate_tpu/utils/modeling.py`),
which reads through the `safetensors` package; the port keeps its own
reader and writer so that it needs no package beyond torch. A file is an
8-byte little-endian header length, a JSON header mapping each tensor's
name to its ``dtype``, ``shape`` and ``data_offsets`` (begin and end byte,
relative to the end of the header), with an optional ``__metadata__`` map of
strings, then the tensors' raw little-endian bytes.

The reader maps the file into memory (``torch.from_file``, private pages)
and returns each tensor as a view of its bytes in the file's own dtype:
nothing is widened to f32 and nothing is copied until a caller copies it,
so a checkpoint is never held twice in host memory.

The size accounting and device-map planning of the same JAX module follow
(`compute_module_sizes`, `infer_auto_device_map` and their helpers). The
planner works on flax paths: a port module is read through
`parallel.sharding`'s flax view (``layers.3.fc1.weight`` is
``params/layer_3/fc1/kernel``, shaped [in, out]), in the order JAX's params
tree flattens (every dict's keys sorted), so a block is the flax path
prefix JAX names and a device map from the port equals JAX's dict for the
same model and budgets. A mapping of flax paths to tensors is taken as it
is.
"""

from __future__ import annotations

import json
import os
import re
import struct
from collections import OrderedDict, defaultdict
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .dataclasses import CustomDtype
from .environment import get_available_host_memory_bytes

#: safetensors dtype name -> torch dtype.
SAFETENSORS_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U16": torch.uint16,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}

#: Metadata key under which old JAX writers listed bf16 tensors stored as
#: U16 views (`accelerate_tpu/utils/hf_loading.py`'s `save_hf_checkpoint`).
BF16_AS_UINT16 = "bfloat16_as_uint16"


def read_safetensors_header(path: str):
    """(header dict without ``__metadata__``, metadata dict, data start byte)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    metadata = header.pop("__metadata__", None) or {}
    return header, metadata, 8 + n


def load_safetensors_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Name -> CPU tensor of a .safetensors file, each in the file's dtype.

    BF16 stays bf16. A tensor that a JAX writer listed under the
    ``bfloat16_as_uint16`` metadata key (stored as U16) comes back as the
    bf16 it was. The tensors are views of one private memory map of the
    file (copy-on-write: writing to one never reaches the file)."""
    header, metadata, start = read_safetensors_header(path)
    viewed = set(filter(None, metadata.get(BF16_AS_UINT16, "").split(",")))
    size = os.path.getsize(path)
    buf = torch.from_file(path, shared=False, size=size, dtype=torch.uint8) if size > start else None
    out = {}
    for name, info in header.items():
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']!r}, which the reader does not map")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        n_items = 1
        for s in shape:
            n_items *= s
        if end - begin != n_items * itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, its shape {shape} needs "
                             f"{n_items * itemsize}")
        if n_items == 0:
            t = torch.empty(shape, dtype=dtype)
        else:
            raw = buf[start + begin : start + end]
            if (start + begin) % itemsize:  # a writer that did not align its tensors
                raw = raw.clone()
            t = raw.view(dtype).reshape(shape)
        if name in viewed:
            t = t.view(torch.bfloat16)
        out[name] = t
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str, metadata: Optional[Dict[str, str]] = None):
    """Write `tensors` (name -> tensor, on any device) as one .safetensors
    file, each in its own dtype (bf16 as BF16), with `metadata` (strings)
    under ``__metadata__``. The tensors are laid out widest type first, so
    every one starts at a multiple of its element size, and each is copied
    to the host only while it is written."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}, which safetensors does not store")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-(8 + len(blob)) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                f.write(t.to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().data)


# ------------------------------------------------------------------ size accounting
DTYPE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2, "int64": 8, "int32": 4, "int8": 1,
               "uint8": 1, "bool": 1}


def dtype_byte_size(dtype) -> float:
    """Bytes per element of a torch dtype, a dtype name or a `CustomDtype`
    (int4 is half a byte)."""
    if isinstance(dtype, CustomDtype):
        return {"int4": 0.5, "fp8": 1, "int8": 1}[dtype.value]
    name = str(dtype).replace("torch.", "")
    if name in DTYPE_BYTES:
        return DTYPE_BYTES[name]
    m = re.search(r"(\d+)", name)
    if m:
        return int(m.group(1)) / 8
    raise ValueError(f"Unknown dtype {dtype}")


def flax_leaves(model: nn.Module) -> List[Tuple[str, str, torch.Tensor, Tuple[int, ...]]]:
    """[(flax path, torch name, parameter, torch dims of the flax dims)] of
    every parameter of `model`, a tied one under each of its names, in the
    order JAX's params tree flattens (keys sorted level by level)."""
    from ..parallel.sharding import _flax_module_path, _leaf

    out, seen = [], set()
    for mod_name, mod in model.named_modules(remove_duplicate=False):
        for pname, param in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            if name in seen:
                continue
            seen.add(name)
            leaf, dims = _leaf(mod, pname, param.dim())
            mpath = _flax_module_path(mod_name)
            out.append(("params/" + (f"{mpath}/" if mpath else "") + leaf, name, param, dims))
    return sorted(out, key=lambda e: e[0].split("/"))


def _path_leaves(params) -> List[Tuple[str, object]]:
    """[(flax path, leaf)] of a module or of a mapping of flax paths, in
    JAX's order."""
    if isinstance(params, nn.Module):
        return [(path, param) for path, _, param, _ in flax_leaves(params)]
    return sorted(params.items(), key=lambda e: e[0].split("/"))


def named_parameter_shapes(params) -> "OrderedDict[str, tuple]":
    """flax path -> (flax shape, dtype) for every leaf, in JAX's order."""
    out = OrderedDict()
    if isinstance(params, nn.Module):
        for path, _, param, dims in flax_leaves(params):
            out[path] = (tuple(param.shape[d] for d in dims), param.dtype)
        return out
    for path, leaf in _path_leaves(params):
        out[path] = (tuple(leaf.shape), leaf.dtype)
    return out


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape) * dtype_byte_size(dtype))


def compute_module_sizes(params, dtype=None, special_dtypes: Optional[dict] = None) -> Dict[str, int]:
    """Bytes of every path prefix, "" for the whole model; floating or not,
    each leaf counts at `dtype` when given (JAX's accounting)."""
    sizes = defaultdict(int)
    for path, (shape, leaf_dtype) in named_parameter_shapes(params).items():
        if special_dtypes is not None and path in special_dtypes:
            size = _nbytes(shape, special_dtypes[path])
        else:
            size = _nbytes(shape, dtype if dtype is not None else leaf_dtype)
        parts = path.split("/")
        for i in range(len(parts) + 1):
            sizes["/".join(parts[:i])] += size
    return dict(sizes)


def group_into_blocks(params, no_split_prefixes: Optional[List[str]] = None,
                      block_depth: int = 2) -> "OrderedDict[str, list]":
    """Block name -> [flax paths]: the placement unit, the path prefix at
    `block_depth` (``params/layer_3``), or a `no_split_prefixes` entry that
    a path falls under ('/'-bounded: ``params/layer_1`` does not take
    ``params/layer_10``)."""
    blocks: "OrderedDict[str, list]" = OrderedDict()
    for path in named_parameter_shapes(params):
        parts = path.split("/")
        prefix = "/".join(parts[:block_depth]) if len(parts) > block_depth else path
        for nsp in no_split_prefixes or ():
            if path == nsp or path.startswith(nsp + "/"):
                prefix = nsp
                break
        blocks.setdefault(prefix, []).append(path)
    return blocks


def get_max_memory(max_memory: Optional[dict] = None) -> "OrderedDict":
    """Tier budgets: each CUDA device by index, then "cpu" and "disk".

    Given values may be bytes or strings ("10GiB", "200MB"). Probed, a card
    offers 90% of its free memory (`torch.cuda.mem_get_info`), the host 90%
    of its available RAM and the disk no limit; with no card, device 0 is
    the CPU itself with half the available RAM, as JAX sizes a CPU device."""
    if max_memory is not None:
        parsed = OrderedDict()
        for k, v in max_memory.items():
            parsed[k] = parse_memory_string(v) if isinstance(v, str) else (v if v == float("inf") else int(v))
        return parsed
    out = OrderedDict()
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[i] = int(torch.cuda.mem_get_info(i)[0] * 0.9)
    else:
        out[0] = int(get_available_host_memory_bytes() // 2 * 0.9)
    out["cpu"] = int(get_available_host_memory_bytes() * 0.9)
    out["disk"] = float("inf")
    return out


_MEMORY_UNITS = {"B": 1, "KB": 10**3, "MB": 10**6, "GB": 10**9, "TB": 10**12, "KIB": 2**10, "MIB": 2**20,
                 "GIB": 2**30, "TIB": 2**40}


def parse_memory_string(value: str) -> int:
    """``"2.5GB"`` -> 2500000000, ``"1KiB"`` -> 1024."""
    m = re.fullmatch(r"\s*([\d.]+)\s*([KMGT]?I?B)\s*", value.upper())
    if not m:
        raise ValueError(f"Cannot parse memory string {value!r}")
    return int(float(m.group(1)) * _MEMORY_UNITS[m.group(2)])


def get_balanced_memory(params, max_memory: Optional[dict] = None, dtype=None, low_zero: bool = False) -> dict:
    """Budgets evened over the devices (each the model's share plus its
    largest block), so the first-fit spreads layers instead of filling
    device 0; one device keeps its budget."""
    max_memory = get_max_memory(max_memory)
    devices = [k for k in max_memory if k not in ("cpu", "disk")]
    if len(devices) <= 1:
        return max_memory
    shapes = named_parameter_shapes(params)
    total = compute_module_sizes(params, dtype=dtype)[""]
    per_device = total // (len(devices) - (1 if low_zero else 0))
    largest_block = max(sum(_nbytes(shapes[p][0], dtype or shapes[p][1]) for p in paths)
                        for paths in group_into_blocks(params).values())
    budget = per_device + largest_block
    out = OrderedDict()
    for k in max_memory:
        if k in ("cpu", "disk"):
            out[k] = max_memory[k]
        elif low_zero and k == devices[0]:
            out[k] = min(max_memory[k], largest_block)
        else:
            out[k] = min(max_memory[k], budget)
    return out


def find_tied_parameters(params) -> List[List[str]]:
    """Groups of flax paths that hold one tensor (a parameter shared by two
    modules, or one leaf under two paths of a mapping)."""
    by_id = defaultdict(list)
    for path, leaf in _path_leaves(params):
        if hasattr(leaf, "shape"):
            by_id[id(leaf)].append(path)
    return [paths for paths in by_id.values() if len(paths) > 1]


def infer_auto_device_map(
    params,
    max_memory: Optional[dict] = None,
    no_split_prefixes: Optional[List[str]] = None,
    dtype=None,
    special_dtypes: Optional[dict] = None,
    verbose: bool = False,
) -> "OrderedDict[str, Union[int, str]]":
    """Block -> tier (a device index, "cpu" or "disk"): JAX's greedy
    first-fit in declaration order, each device keeping room for the
    largest block (a streamed block must fit beside the resident ones), a
    block holding a tied tensor placed with the block that first holds it,
    and whatever fits nowhere on disk."""
    import logging

    max_memory = get_max_memory(max_memory)
    shapes = named_parameter_shapes(params)
    blocks = group_into_blocks(params, no_split_prefixes)

    def block_size(paths) -> int:
        total = 0
        for p in paths:
            shape, leaf_dtype = shapes[p]
            if special_dtypes and p in special_dtypes:
                total += _nbytes(shape, special_dtypes[p])
            else:
                total += _nbytes(shape, dtype or leaf_dtype)
        return total

    sizes = {name: block_size(paths) for name, paths in blocks.items()}
    largest = max(sizes.values())
    device_map: "OrderedDict[str, Union[int, str]]" = OrderedDict()
    used = defaultdict(int)
    tied_groups = find_tied_parameters(params)
    for name, paths in blocks.items():
        placed = None
        for group in tied_groups:
            if any(p in paths for p in group):
                for other in group:
                    for prev_block, tier in device_map.items():
                        if other in blocks.get(prev_block, []):
                            placed = tier
                            break
        if placed is not None:
            device_map[name] = placed
            used[placed] += sizes[name]
            continue
        chosen = None
        for tier, budget in max_memory.items():
            headroom = largest if not isinstance(tier, str) else 0
            if used[tier] + sizes[name] + headroom <= budget:
                chosen = tier
                break
        if chosen is None:
            chosen = "disk"
        device_map[name] = chosen
        used[chosen] += sizes[name]
        if verbose:
            logging.getLogger(__name__).info("block %s (%s bytes) -> %s", name, sizes[name], chosen)
    return device_map


def clean_device_map(device_map: dict) -> dict:
    """Children on one tier folded into their parent prefix; one tier for
    everything is ``{"": tier}``."""
    values = set(device_map.values())
    if len(values) == 1:
        return {"": next(iter(values))}
    out = dict(device_map)
    changed = True
    while changed:
        changed = False
        groups = defaultdict(list)
        for k in list(out):
            parts = k.split("/")
            if len(parts) > 1:
                groups["/".join(parts[:-1])].append(k)
        for parent, kids in groups.items():
            vals = {out[k] for k in kids}
            if len(vals) == 1 and len(kids) > 1:
                v = vals.pop()
                for k in kids:
                    del out[k]
                out[parent] = v
                changed = True
    return out


def calculate_maximum_sizes(params) -> Tuple[int, Tuple[int, str]]:
    """(total bytes, (largest block's bytes, its name))."""
    sizes = compute_module_sizes(params)
    largest_name, largest = "", 0
    for name in group_into_blocks(params):
        if sizes.get(name, 0) > largest:
            largest, largest_name = sizes[name], name
    return sizes[""], (largest, largest_name)
