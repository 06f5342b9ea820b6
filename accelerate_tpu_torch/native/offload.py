"""The disk offload store: one blob of raw tensor bytes and a JSON index
(the port of the JAX package's `native/offload.py`).

Tensors are appended to ``weights.bin``; ``index.json`` maps each name to
its offset, shape and dtype (the dtype's name: ``bfloat16``, ``float32``,
as JAX writes them). The write path is plain Python (offload writes are
cold); the read path, layer weights streamed back while earlier layers
compute, is the C++ pool's striped `pread`, blocking or as readahead
tickets. A read lands in a tensor the caller may give (`out`): the
big-model loop reads straight into pinned staging buffers, so the copy to
the card that follows is asynchronous.
"""

from __future__ import annotations

import ctypes
import json
import os
import time
from typing import Dict, Iterable, Optional, Sequence

import torch


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in the offload index")
    return dtype


def _bytes_view(t: torch.Tensor):
    """A writable uint8 numpy view of a contiguous CPU tensor's bytes."""
    return t.reshape(-1).view(torch.uint8).numpy()


class NativeOffloadStore:
    """Tensor name -> (offset, shape, dtype) in one blob file."""

    INDEX_NAME = "index.json"
    BLOB_NAME = "weights.bin"

    # Single-chunk reads (below the C++ stripe floor) run inline on the calling
    # thread: the pool adds only wakeup latency for them.
    INLINE_READ_BYTES = 8 << 20

    def __init__(self, directory: str, num_threads: int = 4):
        from . import load_library

        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.index_path = os.path.join(directory, self.INDEX_NAME)
        self.blob_path = os.path.join(directory, self.BLOB_NAME)
        self.index: Dict[str, dict] = {}
        if os.path.exists(self.index_path):
            with open(self.index_path) as f:
                self.index = json.load(f)
        self.lib = load_library()
        # More workers than cores is context-switch overhead: pread from the
        # page cache is memory-bandwidth work, not blocking waits.
        num_threads = max(1, min(int(num_threads), os.cpu_count() or 1))
        self._pool = self.lib.atl_pool_create(int(num_threads))
        self._read_fd: Optional[int] = None
        self._write_fd: Optional[int] = None
        # A readahead needs a core to run on; on a 1-core host group prefetch
        # becomes inline reads at read() time.
        self._allow_prefetch = (os.cpu_count() or 1) > 1
        self._store = None
        self._tickets: Dict[str, tuple] = {}
        #: Bytes `save` wrote and its seconds (host copies included).
        self.bytes_written = 0
        self.write_seconds = 0.0

    # -- write --------------------------------------------------------------------
    def save(self, tensors: Dict[str, torch.Tensor], flush_index: bool = True):
        """Append tensors (any device; copied to the host one at a time) to
        the blob and index them. A caller spilling many tensors one call at a
        time passes ``flush_index=False`` and calls `flush_index` once: the
        index rewrite is O(tensors)."""
        self._close_store()
        t0 = time.perf_counter()
        mode = "ab" if os.path.exists(self.blob_path) else "wb"
        with open(self.blob_path, mode) as f:
            for name, t in tensors.items():
                t = t.detach().to("cpu").contiguous()
                offset = f.tell()
                if t.numel():
                    f.write(_bytes_view(t).data)
                    self.bytes_written += t.numel() * t.element_size()
                self.index[name] = {"offset": offset, "shape": list(t.shape),
                                    "dtype": str(t.dtype).replace("torch.", "")}
        self.write_seconds += time.perf_counter() - t0
        if flush_index:
            self.flush_index()

    def write(self, name: str, tensor: torch.Tensor):
        """Overwrite `name` in place (a tensor of the same byte size), else
        append it: the disk optimizer tier rewrites every group each step,
        and `save`'s append-only layout would grow the blob without bound.
        The bytes go out by `pwrite` from `tensor` itself (a host tensor;
        another device's is copied to the host first), so reads that follow
        see them."""
        meta = self.index.get(name)
        if tensor.device.type != "cpu":
            tensor = tensor.detach().to("cpu")
        tensor = tensor.detach().contiguous()
        if meta is None or self._meta(name)[3] != tensor.numel() * tensor.element_size():
            self.save({name: tensor})
            return
        t0 = time.perf_counter()
        if self._write_fd is None:
            self._write_fd = os.open(self.blob_path, os.O_WRONLY)
        view = memoryview(_bytes_view(tensor)) if tensor.numel() else memoryview(b"")
        offset, done = meta["offset"], 0
        while done < len(view):
            done += os.pwrite(self._write_fd, view[done:], offset + done)
        self.bytes_written += done
        self.write_seconds += time.perf_counter() - t0
        shape, dtype = list(tensor.shape), str(tensor.dtype).replace("torch.", "")
        if shape != meta["shape"] or dtype != meta["dtype"]:
            meta["shape"], meta["dtype"] = shape, dtype
            self.flush_index()

    def reserve(self, entries: Iterable[tuple]):
        """Index (name, shape, dtype) entries at the blob's end without
        writing their bytes (the file grows sparse; a read before the first
        `write` gives zeros): room that `write` then fills in place."""
        self._close_store()
        size = os.path.getsize(self.blob_path) if os.path.exists(self.blob_path) else 0
        for name, shape, dtype in entries:
            self.index[name] = {"offset": size, "shape": list(shape), "dtype": str(dtype).replace("torch.", "")}
            numel = 1
            for d in shape:
                numel *= int(d)
            size += numel * torch.empty((), dtype=dtype).element_size()
        with open(self.blob_path, "ab") as f:
            f.truncate(size)
        self.flush_index()

    def flush_index(self):
        with open(self.index_path, "w") as f:
            json.dump(self.index, f)

    def reset(self):
        """Start a fresh blob: a store re-created over a directory must not
        keep (and grow past) a previous run's bytes."""
        self._close_store()
        for path in (self.blob_path, self.index_path):
            if os.path.exists(path):
                os.unlink(path)
        self._close_fds()
        self.index = {}

    # -- read ---------------------------------------------------------------------
    def _open_store(self):
        if self._store is None:
            self._store = self.lib.atl_store_open(self.blob_path.encode())
            if not self._store:
                raise OSError(f"cannot open {self.blob_path}")
        return self._store

    def _close_store(self):
        if self._store is not None:
            self.lib.atl_store_close(self._store)
            self._store = None

    def _close_fds(self):
        for attr in ("_read_fd", "_write_fd"):
            fd = getattr(self, attr)
            if fd is not None:
                os.close(fd)
                setattr(self, attr, None)

    def keys(self):
        return self.index.keys()

    def __contains__(self, name) -> bool:
        return name in self.index

    def _meta(self, name):
        meta = self.index[name]
        shape = tuple(meta["shape"])
        dtype = _dtype(meta["dtype"])
        numel = 1
        for d in shape:
            numel *= d
        return meta["offset"], shape, dtype, numel * torch.empty((), dtype=dtype).element_size()

    def _out(self, name, out: Optional[torch.Tensor]) -> torch.Tensor:
        _, shape, dtype, nbytes = self._meta(name)
        if out is None:
            return torch.empty(shape, dtype=dtype)
        if out.device.type != "cpu" or not out.is_contiguous() or out.numel() * out.element_size() != nbytes:
            raise ValueError(f"out for {name!r} must be a contiguous host tensor of {nbytes} bytes")
        return out.view(dtype).view(shape)

    def _pread_into(self, out: torch.Tensor, offset: int, nbytes: int):
        """Positional read on the calling thread (no pool handoff)."""
        if self._read_fd is None:
            self._read_fd = os.open(self.blob_path, os.O_RDONLY)
        view = memoryview(_bytes_view(out))
        done = 0
        while done < nbytes:
            got = os.preadv(self._read_fd, [view[done:nbytes]], offset + done)
            if got <= 0:
                raise IOError(f"short read at {offset + done} in {self.blob_path}")
            done += got

    def read(self, name: str, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Blocking read into `out` (or a new host tensor); consumes a pending
        readahead of `name` when there is one."""
        if name in self._tickets:
            ticket, got, statuses, i = self._tickets.pop(name)
            rc = self.lib.atl_wait_status(self._pool, ticket)
            if statuses is not None:  # a shared group ticket: this region's status governs
                rc = int(statuses[i])
            if rc != 0:
                raise IOError(f"readahead failed for {name!r} in {self.blob_path}")
            if out is not None and out.data_ptr() != got.data_ptr():
                out.copy_(got)
                return out
            return got
        offset, _, _, nbytes = self._meta(name)
        out = self._out(name, out)
        if nbytes <= self.INLINE_READ_BYTES:
            if nbytes:
                self._pread_into(out, offset, nbytes)
            return out
        rc = self.lib.atl_store_read(self._pool, self._open_store(), offset, nbytes, ctypes.c_void_p(out.data_ptr()))
        if rc != 0:
            raise IOError(f"short read for {name!r} in {self.blob_path}")
        return out

    def prefetch(self, name: str, out: Optional[torch.Tensor] = None):
        """Start an async readahead of `name` into `out` (or a new tensor)."""
        self.prefetch_many([name], None if out is None else [out])

    def prefetch_many(self, names: Iterable[str], outs: Optional[Sequence[torch.Tensor]] = None):
        """Async readahead of a group under ONE pool ticket (one queue handoff
        per layer, not per tensor); names already in flight are skipped. The
        destinations must stay alive until `read` consumes them."""
        names = list(names)
        outs = [None] * len(names) if outs is None else list(outs)
        pairs = [(n, o) for n, o in zip(names, outs) if n not in self._tickets]
        if not pairs or not self._allow_prefetch:
            return
        store = self._open_store()
        n = len(pairs)
        offsets = (ctypes.c_int64 * n)()
        sizes = (ctypes.c_int64 * n)()
        dsts = (ctypes.c_void_p * n)()
        statuses = torch.full((n,), -2, dtype=torch.int32)
        tensors = []
        for i, (name, out) in enumerate(pairs):
            offset, _, _, nbytes = self._meta(name)
            t = self._out(name, out)
            tensors.append(t)
            offsets[i], sizes[i], dsts[i] = offset, nbytes, t.data_ptr()
        ticket = self.lib.atl_store_read_many(
            self._pool, store, n, offsets, sizes, dsts,
            ctypes.cast(statuses.data_ptr(), ctypes.POINTER(ctypes.c_int32)),
        )
        for i, (name, _) in enumerate(pairs):
            # The per-region status array keeps a failure attributable after
            # the shared ticket's first wait has consumed it.
            self._tickets[name] = (ticket, tensors[i], statuses, i)

    def close(self):
        for entry in list(self._tickets.values()):
            self.lib.atl_wait(self._pool, entry[0])
        self._tickets.clear()
        self._close_store()
        self._close_fds()
        if self._pool is not None:
            self.lib.atl_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
