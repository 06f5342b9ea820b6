"""The part of `accelerate_tpu/utils/other.py` the port uses so far:
`convert_bytes`. The rest waits for its ROADMAP A item."""

from __future__ import annotations


def convert_bytes(size: float) -> str:
    """Human-readable byte size, in steps of 1024 (JAX's `convert_bytes`)."""
    for unit in ["bytes", "KB", "MB", "GB", "TB"]:
        if size < 1024.0:
            return f"{round(size, 2)} {unit}"
        size /= 1024.0
    return f"{round(size, 2)} PB"
