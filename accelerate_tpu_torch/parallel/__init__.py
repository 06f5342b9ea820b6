"""Parallel building blocks of the port: the one-device form of the JAX
package's expert parallelism (`parallel/expert.py`), the mesh
(`parallel/mesh.py`), the placement tables (`parallel/sharding.py`), the
data-parallel and FSDP/ZeRO layouts (`parallel/fsdp.py`), tensor
parallel's Megatron blocks (`parallel/tensor.py`) and the cost-model
planner that lays them out (`parallel/planner.py`).

The expert names load on first use: `parallel.expert` builds on the models'
`Dense`, and the models' package imports this one.
"""

import importlib

_EXPERT_NAMES = ("ExpertMLP", "MoEBlock", "expert_capacity", "top_k_routing")

__all__ = list(_EXPERT_NAMES)


def __getattr__(name):
    if name in _EXPERT_NAMES:
        return getattr(importlib.import_module(".expert", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
