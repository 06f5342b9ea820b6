"""The port's native (C++) host data plane: build and ctypes bindings.

`src/data_plane.cpp` (the JAX package's `native/src/data_plane.cpp`, kept
to its offload store) is compiled at first use with the host compiler
(``g++``, which ``nvcc`` needs too; ``CXX`` names another) into the
git-ignored ``build/accelerate_tpu_torch/`` beside the CUDA kernels, under a
name carrying a hash of the source and flags, and loaded with `ctypes`.
Nothing builds at import. Where JAX falls back to numpy reads when the
build fails, the port raises: it has no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "src" / "data_plane.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"the native data plane needs a C++ compiler; {cxx!r} is not on PATH")
    return path


def library_path() -> Path:
    """``build/accelerate_tpu_torch/data_plane-<hash>.so``; the hash covers
    the source and the flags."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"data_plane-{digest}.so"


def build() -> Path:
    """Compile the library unless it is on disk; raises when the compiler
    fails."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    done = subprocess.run([_compiler(), *CXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"building {SRC.name} failed:\n{done.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders race benignly
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.atl_pool_create.argtypes = [c.c_int]
    lib.atl_pool_create.restype = c.c_void_p
    lib.atl_pool_destroy.argtypes = [c.c_void_p]
    lib.atl_pool_size.argtypes = [c.c_void_p]
    lib.atl_pool_size.restype = c.c_int
    lib.atl_wait.argtypes = [c.c_void_p, c.c_int64]
    lib.atl_wait_status.argtypes = [c.c_void_p, c.c_int64]
    lib.atl_wait_status.restype = c.c_int
    lib.atl_store_open.argtypes = [c.c_char_p]
    lib.atl_store_open.restype = c.c_void_p
    lib.atl_store_close.argtypes = [c.c_void_p]
    lib.atl_store_read.argtypes = [c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_void_p]
    lib.atl_store_read.restype = c.c_int
    lib.atl_store_prefetch.argtypes = [c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_void_p]
    lib.atl_store_prefetch.restype = c.c_int64
    lib.atl_store_read_many.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        c.POINTER(c.c_void_p), c.POINTER(c.c_int32),
    ]
    lib.atl_store_read_many.restype = c.c_int64
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once) and load the library; raises where it cannot."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _bind(ctypes.CDLL(str(build())))
    return _LIB


from .offload import NativeOffloadStore  # noqa: E402
