"""Version comparison helpers (the port of `accelerate_tpu/utils/versions.py`).

`compare_versions` is JAX's, line for line. JAX's `is_jax_version` compares
the installed jax; the port never imports jax, so its twin,
`is_torch_version`, compares the installed torch."""

import importlib.metadata
import operator

from packaging.version import Version, parse

STR_OPERATION_TO_FUNC = {
    ">": operator.gt,
    ">=": operator.ge,
    "==": operator.eq,
    "!=": operator.ne,
    "<=": operator.le,
    "<": operator.lt,
}


def compare_versions(library_or_version, operation: str, requirement_version: str) -> bool:
    """Compare a library version (by name or `Version`) against `requirement_version`."""
    if operation not in STR_OPERATION_TO_FUNC:
        raise ValueError(f"`operation` must be one of {list(STR_OPERATION_TO_FUNC)}, got {operation}")
    if isinstance(library_or_version, str):
        library_or_version = parse(importlib.metadata.version(library_or_version))
    return STR_OPERATION_TO_FUNC[operation](library_or_version, parse(requirement_version))


def is_torch_version(operation: str, version: str) -> bool:
    """Compare the installed torch version against `version` (a local
    build tag such as ``+cu128`` is part of the comparison, as `packaging`
    orders it)."""
    import torch

    return compare_versions(parse(torch.__version__), operation, version)


__all__ = ["STR_OPERATION_TO_FUNC", "Version", "compare_versions", "is_torch_version"]
