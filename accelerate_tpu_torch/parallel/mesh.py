"""The device mesh (the port of `accelerate_tpu/parallel/mesh.py`'s
`build_mesh`): a `torch.distributed.device_mesh.DeviceMesh` over the
process group, with JAX's axis names.

The port's mesh has the two data-parallel axes, ("data", "fsdp"), and the
tensor-parallel "model" axis, laid out as JAX lays them (row-major over
the ranks, "model" innermost: rank = (data_index * fsdp + fsdp_index) *
model + model_index). With "model" at 1 the mesh is the two-axis
("data", "fsdp") one. The batch and the gradient average run over
("data", "fsdp") (`data_parallel_group(mesh)`); the "model" ranks of one data
shard see the same batch and hold one Megatron split of the weights
(`parallel.tensor`). The other axes of `ParallelismConfig` are parts of the
JAX package the port has not taken yet; a size above 1 on one of them
raises, naming the ROADMAP bullet that ports it. So does "model" together
with "fsdp" (JAX extends a tensor-parallel dim with "fsdp").
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from ..utils.constants import DATA_AXES
from ..utils.dataclasses import ParallelismConfig

#: Axes above 1 that the port refuses, and the ROADMAP A item 3 bullet that ports each.
WAITING_AXES = {
    "seq": "ROADMAP A item 3, sequence parallel (ring attention over the block-level flash entries)",
    "expert": "ROADMAP A item 3, expert sharding",
    "stage": "ROADMAP A item 3, pipelines",
    "pipeline": "ROADMAP A item 3, pipelines",
}

#: The ROADMAP A item 3 bullet that ports "model" together with "fsdp".
MODEL_WITH_FSDP = "ROADMAP A item 3, tensor parallel with \"fsdp\" (the Megatron dim extended by \"fsdp\")"

#: The mesh's axes, outermost first.
MESH_AXES = DATA_AXES + ("model",)


def refuse_waiting_axes(sizes: dict):
    """Raise for an axis above 1 that the port does not run, and for
    "model" above 1 together with "fsdp" above 1, naming the bullet that
    ports it."""
    for axis, bullet in WAITING_AXES.items():
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(f"mesh axis {axis!r} of size {sizes[axis]}: waits for {bullet}")
    if sizes.get("model", 1) > 1 and sizes.get("fsdp", 1) > 1:
        raise NotImplementedError(
            f"mesh axis 'model' of size {sizes['model']} together with 'fsdp' of size {sizes['fsdp']}: "
            f"waits for {MODEL_WITH_FSDP}")


def resolve_mesh_sizes(parallelism: Optional[ParallelismConfig], num_processes: int) -> dict:
    """{"data": n, "fsdp": m, "model": t} for `num_processes` ranks; raises
    for an axis the port does not run."""
    sizes = (parallelism or ParallelismConfig()).resolve(num_processes)
    refuse_waiting_axes(sizes)
    return {axis: sizes[axis] for axis in MESH_AXES}


def build_mesh(parallelism: Optional[ParallelismConfig] = None):
    """The `DeviceMesh` of the process group, on the group's device type
    (cuda under NCCL, cpu under gloo): ("data", "fsdp"), or ("data",
    "fsdp", "model") with a "model" axis above 1."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group (PartialState under a launcher)")
    sizes = resolve_mesh_sizes(parallelism, dist.get_world_size())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    axes = MESH_AXES if sizes["model"] > 1 else DATA_AXES
    return init_device_mesh(device_type, tuple(sizes[a] for a in axes), mesh_dim_names=axes)


def mesh_sizes(mesh) -> dict:
    """{axis: size} of a mesh, "model" 1 when the mesh has no such axis."""
    sizes = {"model": 1}
    sizes.update(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))
    return sizes


def data_parallel_group(mesh):
    """The process group a batch is split and a gradient averaged over
    under `mesh`: the "data" ranks of this process's "model" index where
    the mesh has a "model" axis above 1 ("fsdp" is 1 there,
    `refuse_waiting_axes`), else None (every process; also without a
    mesh)."""
    if mesh is None or mesh_sizes(mesh)["model"] == 1:
        return None
    return mesh["data"].get_group()
