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

The tensor-parallel half is JAX's too: `spec_for_param` takes the family's
Megatron rules (`LLAMA_SHARDING_RULES`, ...) first, a rule's "model" dim
extended by "fsdp" where both apply, as JAX's does; `serving_tp_mesh` picks
a serving engine's ranks; `derive_tp_param_shardings` and
`derive_tp_cache_shardings` are JAX's tables over the flax view of the
engine's weights and a named view of its pools (`tp_cache_tree`), and
`tree_device_nbytes` counts the bytes this rank holds. `parallel.tensor`
applies the tables: each rank keeps its split of every rule-matched weight
and of the KV pool's heads. ``sharding_rules="auto"`` is lowered to such a
table by the cost-model planner (`parallel.planner`) before it reaches
these functions; on a training mesh with a "data" axis the planner also
emits an optimizer-state table (`derive_opt_state_placements`'s
`opt_rules`: ZeRO moments over "data").
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.constants import DATA_AXES

_SMALL_PARAM_DEFAULT = 2**16  # below this, sharding costs more than it saves (JAX's threshold)

logger = logging.getLogger(__name__)


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


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def check_resolved(rules):
    """A sentinel (``"auto"``) must be lowered to a table before a spec is
    derived (JAX's error)."""
    if isinstance(rules, str):
        raise ValueError(
            f"rules={rules!r} reached spec derivation unresolved — the 'auto' "
            "sentinel must be lowered to a table first (parallel.planner."
            "plan_sharding, or the Accelerator/ContinuousBatcher seams that "
            "call it)"
        )


def spec_for_param(path: str, shape: Sequence[int], mesh_sizes: dict, fsdp_plugin=None,
                   min_shard_size: Optional[int] = None, shard_single: bool = False,
                   rules: Optional[Sequence] = None) -> tuple:
    """JAX's spec for one parameter in flax layout: a tuple with the mesh
    axes of each sharded dim (trailing Nones dropped), or ``()``.
    `mesh_sizes` maps axis names to sizes. The first of `rules` (``(path
    regex, spec)`` pairs, the family's Megatron table) that matches the
    path gives the tensor-parallel spec; then "fsdp" joins it. A rule's
    sharded dim is extended by "fsdp" where the group divides it (JAX's
    Megatron+ZeRO convention), else "fsdp" takes a free dim. The wrap
    policy decides which parameters join the shard group: SIZE_BASED_WRAP
    or None a size threshold (`min_num_params`, else 2**16);
    TRANSFORMER_BASED_WRAP only paths matching a
    `transformer_cls_names_to_wrap` pattern; NO_WRAP every divisible
    parameter.

    `shard_single`: over a one-member "fsdp" axis a shard is the whole
    tensor, and JAX's table is all replicated; with it, the table instead
    names the dim each parameter would shard on, so `prepare` can run the
    sharded machinery (the group, the wrapped module, the collectives) at
    one process. The placement is the same."""
    check_resolved(rules)
    shape = tuple(shape)
    size = int(np.prod(shape)) if shape else 1
    spec = [None] * len(shape)
    matched = False
    for pattern, rule_spec in rules or ():
        if re.search(pattern, path):
            rule_spec = tuple(rule_spec)[: len(shape)]
            spec = list(rule_spec) + [None] * (len(shape) - len(rule_spec))
            matched = True
            break
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
    used = {axis for entry in spec for axis in _axes(entry)}
    if (fsdp_size > 1 or shard_single) and shards_params and size >= threshold and "fsdp" not in used:
        taken = {i for i, entry in enumerate(spec) if entry is not None}
        extended = False
        if matched and taken:
            for i in sorted(taken, reverse=True):
                group = fsdp_size * int(np.prod([mesh_sizes.get(a, 1) for a in _axes(spec[i])]))
                if shape[i] % group == 0 and shape[i] >= group:
                    spec[i] = _axes(spec[i]) + ("fsdp",)
                    extended = True
                    break
        if not extended:
            dim = _fsdp_dim(path, shape, fsdp_size, taken)
            if dim is not None and spec[dim] is None:
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
    leaf: str = ""  # the path's last key (``kernel``; a bare parameter's ``w_gate/kernel``)

    @property
    def keys(self) -> List[str]:
        """The path's keys in JAX's tree (a leaf name may hold a '/')."""
        return self.path[: -len(self.leaf) - 1].split("/") + [self.leaf]

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
            views.append(ParamView(f"{mod_name}.{pname}" if mod_name else pname, path, shape, dims, leaf))
    order = {name: i for i, (name, _) in enumerate(module.named_parameters())}
    return sorted(views, key=lambda v: order.get(v.name, len(order)))


def derive_param_placements(module: nn.Module, mesh_sizes: dict, fsdp_plugin=None,
                            shard_single: bool = False) -> Dict[str, Optional[int]]:
    """{parameter name: torch dim sharded over "fsdp", or None}: JAX's
    `derive_param_shardings` over the module's flax view."""
    return {v.name: v.torch_dim(spec_for_param(v.path, v.flax_shape, mesh_sizes, fsdp_plugin,
                                               shard_single=shard_single))
            for v in flax_view(module)}


def spec_legal(spec: tuple, shape, mesh_sizes: dict) -> bool:
    """True when every sharded dim of `shape` divides by the product of its
    axes' sizes (JAX's `_spec_legal`)."""
    for dim, entry in enumerate(spec):
        group = int(np.prod([int(mesh_sizes.get(a, 1)) for a in _axes(entry)])) if entry is not None else 1
        if group > 1 and (dim >= len(shape) or shape[dim] % group != 0):
            return False
    return True


def opt_rule_spec(path: str, shape, opt_rules, mesh_sizes: dict) -> Optional[tuple]:
    """The optimizer-state table's spec of one moment (JAX's
    `_opt_rule_spec`): the first matching entry's spec at full rank, ``()``
    when it does not divide this leaf, None when no entry matches."""
    for pattern, spec in opt_rules or ():
        if re.search(pattern, path):
            full = tuple(spec) + (None,) * (len(shape) - len(spec))
            return full if spec_legal(full, shape, mesh_sizes) else ()
    return None


def _data_dim(view: ParamView, spec: tuple) -> Optional[int]:
    """The torch dim of `view` that `spec` shards over "data", or None. A
    dim sharded over ("model", "data") nests the data shard inside this
    rank's model chunk (JAX's major-to-minor order), which is what a chunk
    of the rank's split over "data" is: "data" must come last."""
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        if "data" in axes:
            if axes[-1] != "data":
                raise NotImplementedError(f"{view.path}: optimizer-state spec {spec} nests \"data\" outside another "
                                          "axis of its dim")
            return view.torch_dims[i]
    return None


def derive_opt_state_placements(module: nn.Module, mesh_sizes: dict, fsdp_plugin=None,
                                 shard_single: bool = False, opt_rules=None) -> Dict[str, Optional[int]]:
    """{parameter name: torch dim its optimizer moments shard on, or None}:
    JAX's `derive_opt_state_shardings` (moments shaped like their
    parameter; a step count is a scalar and replicates).

    With `opt_rules` (the planner's ZeRO table, `ShardingPlan.opt_rules`)
    the table is authoritative, as in JAX: a matched moment takes its
    entry's spec (a spec that does not divide the leaf replicates) and the
    dim is the one it shards over "data"; a moment no entry matches stays
    with its parameter (None: it follows the parameter's "model" split, if
    any). The table is read against the whole module (JAX's global
    shapes), before a tensor-parallel split."""
    if opt_rules:
        out = {}
        for view in flax_view(module):
            spec = opt_rule_spec(view.path, view.flax_shape, opt_rules, mesh_sizes)
            out[view.name] = None if spec is None else _data_dim(view, spec)
        return out
    plugin = opt_state_plugin(fsdp_plugin)
    return derive_param_placements(module, mesh_sizes, plugin, shard_single=shard_single)


def data_spec(mesh_sizes: Optional[dict] = None) -> tuple:
    """The batch's placement: dim 0 over ("data", "fsdp"), as JAX's
    `data_spec`; rank r of the row-major mesh takes the r-th contiguous
    share of the global batch."""
    return (DATA_AXES,)


# ------------------------------------------------------------------ tensor parallel
def serving_tp_mesh(tp: int, devices: Optional[Sequence[int]] = None, group: int = 0) -> List[int]:
    """The ranks of a `tp`-wide serving engine (JAX's one-axis ("model",)
    submesh, over the process group's ranks): `devices` names them, else
    the g-th disjoint block of `tp` ranks, wrapping, with JAX's warning,
    when the world has fewer than ``(group + 1) * tp`` ranks."""
    import torch.distributed as dist

    tp = int(tp)
    if tp < 1:
        raise ValueError("tp must be >= 1")
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if devices is None:
        groups = max(world // tp, 1)
        g = int(group)
        if g >= groups:
            logger.warning(
                "serving_tp_mesh: group %d wraps onto rank block %d — only %d disjoint %d-rank group(s) exist "
                "across %d rank(s), so this engine SHARES ranks with group %d. Fine for CPU smoke runs; on real "
                "hardware shrink replicas or tp.", g, g % groups, groups, tp, world, g % groups)
        start = (g % groups) * tp
        devices = list(range(world))[start:start + tp]
    devices = [int(d) for d in devices]
    if len(devices) != tp:
        raise ValueError(f"tensor-parallel degree {tp} needs exactly {tp} devices, got {len(devices)} "
                         f"(of {world} visible)")
    return devices


def _check_tp_divisible(path: str, shape, spec, mesh_sizes: dict):
    """A rule-sharded dim must divide by its axis group: an indivisible rule
    is a hard error naming the leaf (JAX's), never a silent replication."""
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        group = int(np.prod([mesh_sizes.get(a, 1) for a in axes])) if axes else 1
        if group > 1 and shape[i] % group:
            raise ValueError(
                f"TP rule shards {path} dim {i} (size {shape[i]}) over axes {axes} (group size {group}), which "
                f"does not divide — pick a tp that divides the model's head/hidden dims")


def tp_views(module: nn.Module) -> List[ParamView]:
    """`flax_view` plus the leaves of each `Int8Linear` (JAX's quantized
    entry under the kernel's path: ``kernel/q`` [in, out] int8 and
    ``kernel/scale`` [out], and the layer's ``bias``), so the serving
    tables cover an int8 engine's weights as JAX's cover its tree."""
    from ..ops.quantization import Int8Linear

    views = flax_view(module)
    for mod_name, mod in module.named_modules():
        if not isinstance(mod, Int8Linear):
            continue
        base = "params/" + (f"{_flax_module_path(mod_name)}/" if mod_name else "")
        prefix = f"{mod_name}." if mod_name else ""
        views.append(ParamView(prefix + "q", base + "kernel/q", tuple(mod.q.shape[::-1]), (1, 0), "q"))
        views.append(ParamView(prefix + "scale", base + "kernel/scale", tuple(mod.scale.shape), (0,), "scale"))
        if mod.bias is not None:
            views.append(ParamView(prefix + "bias", base + "bias", tuple(mod.bias.shape), (0,), "bias"))
    return views


def tp_spec(path: str, shape, mesh_sizes: dict, rules) -> tuple:
    """JAX's serving spec of one leaf (`derive_tp_param_shardings`'s rule):
    a quantized kernel's scale vector follows the kernel's output dim (the
    rule's last entry: column-parallel scales shard, row-parallel ones
    replicate); every other leaf takes `spec_for_param` with the rules and
    no fsdp. Raises for a rule that does not divide its dim."""
    check_resolved(rules)
    shape = tuple(shape)
    if path.endswith("kernel/scale") and len(shape) == 1:
        axis = None
        for pattern, rule_spec in rules or ():
            if re.search(pattern, path):
                axis = tuple(rule_spec)[-1] if tuple(rule_spec) else None
                break
        spec = (axis,) if axis is not None else ()
    else:
        spec = spec_for_param(path, shape, mesh_sizes, None, rules=rules)
    _check_tp_divisible(path, shape, spec, mesh_sizes)
    return spec


def derive_tp_param_shardings(module: nn.Module, mesh_sizes: dict, rules) -> Dict[str, tuple]:
    """{flax path: spec} for a serving engine's weights, Megatron rules only
    (JAX's `derive_tp_param_shardings` over the flax view, `tp_views`)."""
    return {v.path: tp_spec(v.path, v.flax_shape, mesh_sizes, rules) for v in tp_views(module)}


def _tp_cache_spec(path: str, ndim: int, axis: str = "model") -> tuple:
    """The spec of one slot-cache leaf, by leaf name (JAX's): K/V pools or
    rows ([..., heads, head_dim]) shard their heads dim, the quantized
    pools' [num_pages, heads] scales their trailing heads dim, anything
    else replicates."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("cached_key", "cached_value") and ndim >= 2:
        spec = [None] * ndim
        spec[ndim - 2] = axis
        return tuple(spec)
    if leaf in ("key_scale", "value_scale") and ndim >= 1:
        spec = [None] * ndim
        spec[ndim - 1] = axis
        return tuple(spec)
    return ()


_CACHE_LEAVES = ("cached_key", "cached_value", "key_scale", "value_scale")


def tp_cache_tree(pools) -> dict:
    """The engine's pools (one (k, v[, k_scale, v_scale]) tuple per layer)
    named as JAX's slot cache names its leaves: ``layer_{i}/attention/
    cached_key`` and so on."""
    return {f"layer_{i}": {"attention": dict(zip(_CACHE_LEAVES, layer))} for i, layer in enumerate(pools)}


def derive_tp_cache_shardings(cache, mesh_sizes: dict, axis: str = "model") -> Dict[str, tuple]:
    """{path: spec} for a slot cache tree (`tp_cache_tree`, shapes or
    tensors): K/V by KV head over `axis`, scale pools by head, the rest
    replicated, each checked to divide (JAX's `derive_tp_cache_shardings`).

    JAX's `constrain_tp_cache` (a sharding constraint inside each program,
    so GSPMD keeps the pool's layout) has no counterpart: each rank's pools
    are plain tensors that hold only its own heads, from construction on."""
    out = {}
    for path, leaf in tree_paths_and_leaves(cache):
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        spec = _tp_cache_spec(path, len(shape), axis)
        _check_tp_divisible(path, shape, spec, mesh_sizes)
        out[path] = spec
    return out


def tree_device_nbytes(tree) -> int:
    """Stored bytes this rank holds of a tree of tensors, or of a module's
    parameters and buffers, each tensor once: under tensor parallel a
    sharded leaf counts its local split, a replicated one its whole size."""
    if isinstance(tree, nn.Module):
        leaves = [*tree.parameters(), *tree.buffers()]
    else:
        leaves = [leaf for _, leaf in tree_paths_and_leaves(tree)]
    seen = {id(t): t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor)}
    return int(sum(seen.values()))
