"""Which optional packages are installed: the port's own copy of the checks
of `accelerate_tpu/utils/imports.py` that its trackers, `utils/tqdm.py` and
`utils/rich.py` need. Each looks for the package without importing it and
is cached."""

import importlib.util
from functools import lru_cache


def _is_package_available(pkg_name: str) -> bool:
    return importlib.util.find_spec(pkg_name) is not None


@lru_cache
def is_tensorboard_available() -> bool:
    return _is_package_available("tensorboardX") or _is_package_available("tensorboard")


@lru_cache
def is_wandb_available() -> bool:
    return _is_package_available("wandb")


@lru_cache
def is_mlflow_available() -> bool:
    return _is_package_available("mlflow")


@lru_cache
def is_comet_ml_available() -> bool:
    return _is_package_available("comet_ml")


@lru_cache
def is_aim_available() -> bool:
    return _is_package_available("aim")


@lru_cache
def is_clearml_available() -> bool:
    return _is_package_available("clearml")


@lru_cache
def is_dvclive_available() -> bool:
    return _is_package_available("dvclive")


@lru_cache
def is_rich_available() -> bool:
    return _is_package_available("rich")


@lru_cache
def is_tqdm_available() -> bool:
    return _is_package_available("tqdm")
