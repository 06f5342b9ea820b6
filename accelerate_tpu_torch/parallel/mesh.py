"""The device mesh (the port of `accelerate_tpu/parallel/mesh.py`'s
`build_mesh`): a `torch.distributed.device_mesh.DeviceMesh` over the
process group, with JAX's axis names.

The port's mesh has the two data-parallel axes, ("data", "fsdp"), laid out
as JAX lays them (row-major over the ranks: rank = data_index * fsdp +
fsdp_index). The other axes of `ParallelismConfig` are parts of the JAX
package the port has not taken yet; a size above 1 on one of them raises,
naming the ROADMAP bullet that ports it.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from ..utils.constants import DATA_AXES
from ..utils.dataclasses import ParallelismConfig

#: Axes above 1 that the port refuses, and the ROADMAP A item 3 bullet that ports each.
WAITING_AXES = {
    "model": "ROADMAP A item 3, tensor parallel (serving, training's \"model\" axis and the planner)",
    "seq": "ROADMAP A item 3, sequence parallel (ring attention over the block-level flash entries)",
    "expert": "ROADMAP A item 3, expert sharding",
    "stage": "ROADMAP A item 3, pipelines",
    "pipeline": "ROADMAP A item 3, pipelines",
}


def resolve_mesh_sizes(parallelism: Optional[ParallelismConfig], num_processes: int) -> dict:
    """{"data": n, "fsdp": m} for `num_processes` ranks; raises for an axis
    the port does not run."""
    sizes = (parallelism or ParallelismConfig()).resolve(num_processes)
    for axis, bullet in WAITING_AXES.items():
        if sizes[axis] > 1:
            raise NotImplementedError(f"mesh axis {axis!r} of size {sizes[axis]}: waits for {bullet}")
    return {axis: sizes[axis] for axis in DATA_AXES}


def build_mesh(parallelism: Optional[ParallelismConfig] = None):
    """The ("data", "fsdp") `DeviceMesh` of the process group, on the
    group's device type (cuda under NCCL, cpu under gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group (PartialState under a launcher)")
    sizes = resolve_mesh_sizes(parallelism, dist.get_world_size())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes[a] for a in DATA_AXES), mesh_dim_names=DATA_AXES)

