"""Parallel building blocks of the port: so far the one-device form of the
JAX package's expert parallelism (`parallel/expert.py`)."""

from .expert import ExpertMLP, MoEBlock, expert_capacity, top_k_routing

__all__ = ["ExpertMLP", "MoEBlock", "expert_capacity", "top_k_routing"]
