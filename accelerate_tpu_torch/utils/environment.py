"""Host probing: the part of `accelerate_tpu/utils/environment.py` the
big-model planner uses (`get_host_memory_bytes`,
`get_available_host_memory_bytes`), read from ``/proc/meminfo`` as JAX
reads it. The rest of that file waits for its ROADMAP A item."""

from __future__ import annotations


def _meminfo(key: str) -> int:
    """``/proc/meminfo``'s `key` in bytes, or 0 where it cannot be read."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def get_host_memory_bytes() -> int:
    """Total host RAM in bytes."""
    return _meminfo("MemTotal")


def get_available_host_memory_bytes() -> int:
    """Host RAM the kernel reports available (``MemAvailable``), or half of
    the total where that line is missing, as JAX falls back."""
    return _meminfo("MemAvailable") or get_host_memory_bytes() // 2
