"""Which parameter shards where: the training half of
`accelerate_tpu/parallel/sharding.py`, over the port's modules.

JAX derives a `PartitionSpec` for every leaf of the flax params tree and
lets GSPMD place it; the port derives the same table and `prepare` applies
it (`modeling.PreparedModel`). A placement is one dim of the parameter
sharded over the mesh's "fsdp" axis, or None (replicated); the batch is
split over ("data", "fsdp") (`data_spec`).

The rules are JAX's, evaluated on the flax view of each torch parameter
(`flax_view`): its flax path (``params/layer_0/attention/wq/kernel`` for
``layers.0.attention.wq.weight``) and its flax shape. A flax `Dense` kernel
is [in, out] and a torch `Linear.weight` [out, in], so JAX's "last (output)
dim" is torch dim 0; a flax conv kernel is [kh, kw, in, out], a torch one
[out, in, kh, kw]. Each view carries the map from flax dims to torch dims,
so a user's `transformer_cls_names_to_wrap` patterns, the size threshold,
the divisibility rule and the embedding rule mean what they mean in JAX.

The tensor-parallel half (`serving_tp_mesh`, `derive_tp_*`) and the
planner's rule tables wait for ROADMAP A item 3, tensor parallel.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from torch import nn

from ..utils.constants import DATA_AXES

_SMALL_PARAM_DEFAULT = 2**16  # below this, sharding costs more than it saves (JAX's threshold)


def tree_paths_and_leaves(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """[(path, leaf)] of a nested dict/list/tuple, paths '/'-joined as
    JAX's `tree_paths_and_leaves` writes them (list entries by index)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, value in items:
        out += tree_paths_and_leaves(value, f"{prefix}/{key}" if prefix else str(key))
    return out


def _fsdp_dim(path: str, shape, fsdp_size: int, taken_dims: set) -> Optional[int]:
    """The (flax) dim to shard over "fsdp", keeping contraction dims
    replicated, as JAX picks it: an embedding table its dim 0 (vocab), a
    kernel its last (output) dim, anything else its largest free dim; only
    dims that `fsdp_size` divides."""
    candidates = [i for i, d in enumerate(shape) if i not in taken_dims and d % fsdp_size == 0 and d >= fsdp_size]
    if not candidates:
        return None
    if ("embedding" in path.rsplit("/", 1)[-1] or "embed" in path) and 0 in candidates:
        return 0
    if len(shape) >= 2 and (len(shape) - 1) in candidates:
        return len(shape) - 1
    return max(candidates, key=lambda i: shape[i])


def spec_for_param(path: str, shape: Sequence[int], mesh_sizes: dict, fsdp_plugin=None,
                   min_shard_size: Optional[int] = None, shard_single: bool = False) -> tuple:
    """JAX's spec for one parameter in flax layout: a tuple with "fsdp" at
    the sharded dim (trailing Nones dropped), or ``()``. `mesh_sizes` maps
    axis names to sizes. The wrap policy decides which parameters join
    the shard group: SIZE_BASED_WRAP or None a size threshold
    (`min_num_params`, else 2**16); TRANSFORMER_BASED_WRAP only paths
    matching a `transformer_cls_names_to_wrap` pattern; NO_WRAP every
    divisible parameter.

    `shard_single`: over a one-member "fsdp" axis a shard is the whole
    tensor, and JAX's table is all replicated; with it, the table instead
    names the dim each parameter would shard on, so `prepare` can run the
    sharded machinery (the group, the wrapped module, the collectives) at
    one process. The placement is the same."""
    shape = tuple(shape)
    size = int(np.prod(shape)) if shape else 1
    spec = [None] * len(shape)
    fsdp_size = int(mesh_sizes.get("fsdp", 1))
    shards_params = fsdp_plugin is not None and fsdp_plugin.shards_params
    policy = getattr(fsdp_plugin, "auto_wrap_policy", None) if fsdp_plugin else None
    threshold = min_shard_size
    if threshold is None:
        threshold = fsdp_plugin.min_num_params if (fsdp_plugin and fsdp_plugin.min_num_params) else _SMALL_PARAM_DEFAULT
    if policy == "NO_WRAP":
        threshold = 1
    elif policy == "TRANSFORMER_BASED_WRAP" and shards_params:
        wrap_names = getattr(fsdp_plugin, "transformer_cls_names_to_wrap", None) or []
        if not any(re.search(pat, path) for pat in wrap_names):
            shards_params = False
    if (fsdp_size > 1 or shard_single) and shards_params and size >= threshold:
        dim = _fsdp_dim(path, shape, fsdp_size, set())
        if dim is not None:
            spec[dim] = "fsdp"
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


class _OptPlugin:
    """The plugin the moments are placed under: every strategy that shards
    optimizer state places a moment exactly where its parameter would go if
    the parameters were sharded (JAX's `derive_opt_state_shardings`), with
    the wrap knobs carried through."""

    shards_params = True

    def __init__(self, plugin):
        self.min_num_params = getattr(plugin, "min_num_params", 0)
        self.auto_wrap_policy = getattr(plugin, "auto_wrap_policy", None)
        self.transformer_cls_names_to_wrap = getattr(plugin, "transformer_cls_names_to_wrap", None)


def opt_state_plugin(fsdp_plugin):
    """The plugin `spec_for_param` places optimizer state under, or None
    when the strategy keeps it replicated."""
    shards_opt = fsdp_plugin is not None and fsdp_plugin.shards_opt_state
    return _OptPlugin(fsdp_plugin) if shards_opt else None


# ------------------------------------------------------------------ the flax view
@dataclass(frozen=True)
class ParamView:
    """One torch parameter as JAX names and shapes it: `torch_dims[i]` is
    the torch dim of flax dim i."""

    name: str
    path: str
    flax_shape: Tuple[int, ...]
    torch_dims: Tuple[int, ...]

    def torch_dim(self, spec: tuple) -> Optional[int]:
        """The torch dim a flax spec shards, or None."""
        for i, entry in enumerate(spec):
            if entry is not None:
                return self.torch_dims[i]
        return None


_LIST_ENTRY = re.compile(r"(?:^|(?<=/))([A-Za-z_]\w*)/(\d+)(?=/|$)")


def _flax_module_path(module_name: str) -> str:
    """``layers.0.attention`` -> ``layer_0/attention`` (a `ModuleList` entry
    ``<name>.<i>`` is flax's ``<name>_<i>``; Llama's and the families'
    ``layers`` list is flax's ``layer_<i>``)."""
    path = module_name.replace(".", "/")

    def entry(m):
        name = "layer" if m.group(1) == "layers" else m.group(1)
        return f"{name}_{m.group(2)}"

    return _LIST_ENTRY.sub(entry, path)


def _leaf(module: nn.Module, pname: str, ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """The flax leaf name of `module`'s parameter `pname` and its flax dims'
    torch dims."""
    identity = tuple(range(ndim))
    if isinstance(module, nn.Linear) and pname == "weight":
        return "kernel", (1, 0)
    if isinstance(module, nn.Conv2d) and pname == "weight":
        return "kernel", (2, 3, 1, 0)
    if isinstance(module, nn.Embedding) and pname == "weight":
        return ("rel_embedding" if type(module).__name__ == "T5RelativeBias" else "embedding"), identity
    if pname == "weight" and ndim == 1:
        return "scale", identity
    if pname == "bias":
        return "bias", identity
    return f"{pname}/kernel", identity


def flax_view(module: nn.Module) -> List[ParamView]:
    """Every parameter of `module` with its flax path and shape, in
    `named_parameters` order (a tied parameter once, under its first name)."""
    views, seen = [], set()
    for mod_name, mod in module.named_modules():
        for pname, param in mod.named_parameters(recurse=False):
            if id(param) in seen:
                continue
            seen.add(id(param))
            leaf, dims = _leaf(mod, pname, param.dim())
            mpath = _flax_module_path(mod_name)
            path = "params/" + (f"{mpath}/" if mpath else "") + leaf
            shape = tuple(param.shape[d] for d in dims)
            views.append(ParamView(f"{mod_name}.{pname}" if mod_name else pname, path, shape, dims))
    order = {name: i for i, (name, _) in enumerate(module.named_parameters())}
    return sorted(views, key=lambda v: order.get(v.name, len(order)))


def derive_param_placements(module: nn.Module, mesh_sizes: dict, fsdp_plugin=None,
                            shard_single: bool = False) -> Dict[str, Optional[int]]:
    """{parameter name: torch dim sharded over "fsdp", or None}: JAX's
    `derive_param_shardings` over the module's flax view."""
    return {v.name: v.torch_dim(spec_for_param(v.path, v.flax_shape, mesh_sizes, fsdp_plugin,
                                               shard_single=shard_single))
            for v in flax_view(module)}


def derive_opt_state_placements(module: nn.Module, mesh_sizes: dict, fsdp_plugin=None,
                                 shard_single: bool = False) -> Dict[str, Optional[int]]:
    """{parameter name: torch dim its optimizer moments shard on, or None}:
    JAX's `derive_opt_state_shardings` (moments shaped like their
    parameter; a step count is a scalar and replicates)."""
    plugin = opt_state_plugin(fsdp_plugin)
    return derive_param_placements(module, mesh_sizes, plugin, shard_single=shard_single)


def data_spec(mesh_sizes: Optional[dict] = None) -> tuple:
    """The batch's placement: dim 0 over ("data", "fsdp"), as JAX's
    `data_spec`; rank r of the row-major mesh takes the r-th contiguous
    share of the global batch."""
    return (DATA_AXES,)
