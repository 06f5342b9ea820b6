"""Utilities of the port's training slice."""

from .dataclasses import GradientAccumulationPlugin, PrecisionType
from .operations import send_to_device
from .random import set_seed

__all__ = ["GradientAccumulationPlugin", "PrecisionType", "send_to_device", "set_seed"]
