"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) into ``build/accelerate_tpu_torch/``
beside the package and loaded with `ctypes`. The library's file name carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded. Several sources build in parallel, one ``nvcc`` each.

Nothing here runs at import: a wrapper calls `load` only when it is handed a
CUDA tensor, so the CPU tests import every module without ``nvcc``.

A build is the only compile an eager port makes: `build` calls each of
`BUILD_LISTENERS` once per library it really compiles, with the source's
name and the build's seconds (the counterpart of JAX's backend-compile
duration event, which the tracer, the step timeline and the trace guard
listen to). A library already on disk emits nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "accelerate_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
#: The compiler's output of each library built by this process (ptxas prints
#: registers, shared memory and spills per kernel), and its build seconds.
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}
#: ``listener(name, seconds)``, called once per library compiled.
BUILD_LISTENERS: List[Callable[[str, float], None]] = []

logger = logging.getLogger(__name__)


def add_build_listener(listener: Callable[[str, float], None]) -> Callable[[str, float], None]:
    """Register `listener` (once; registering it again is a no-op)."""
    if listener not in BUILD_LISTENERS:
        BUILD_LISTENERS.append(listener)
    return listener


def remove_build_listener(listener: Callable[[str, float], None]):
    """Unregister `listener` (a no-op when it is not registered)."""
    if listener in BUILD_LISTENERS:
        BUILD_LISTENERS.remove(listener)


def _notify_built(name: str, seconds: float):
    for listener in list(BUILD_LISTENERS):
        try:
            listener(name, seconds)
        except Exception:  # noqa: BLE001 — telemetry never fails a build
            logger.warning("build listener %r failed for %s", listener, name, exc_info=True)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")
    return path


def library_path(name: str) -> Path:
    """`build/accelerate_tpu_torch/<name>-<hash>.so` for `csrc/<name>.cu`; the
    hash covers the source, every header in `csrc/` and the flags."""
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source (default: all of `csrc/*.cu`) whose library
    is missing, all ``nvcc`` processes started together. Returns build seconds
    per library built; raises with the compiler's output if one fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        _notify_built(name, BUILD_SECONDS[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: BUILD_SECONDS[name] for name in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
