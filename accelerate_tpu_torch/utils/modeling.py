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
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import torch

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
