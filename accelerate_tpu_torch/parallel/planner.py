"""The cost-model planner (the port of `accelerate_tpu/parallel/planner.py`):
``sharding_rules="auto"``'s search for a tensor-parallel layout, and on a
training mesh with a "data" axis for ZeRO optimizer-state sharding.

The planner reads shapes and dtypes only. It enumerates candidate specs
for each parameter (its flax path and flax shape: `parallel.sharding`'s
`flax_view`, so ``layers.0.attention.wq.weight`` is
``params/layer_0/attention/wq/kernel`` [in, out] as in JAX), prices each
whole plan with JAX's analytic model (per-chip bytes of parameters,
optimizer moments and the KV pool; collective bytes of each placement; a
step time from FLOPs, memory and interconnect rates of a `ChipSpec`),
beam-searches, and emits a ``(pattern, spec)`` rules table in the shape
`spec_for_param`, `tp_spec` and `parallel.tensor.shard_module` consume.
The arithmetic is JAX's, operation for operation and in JAX's order, with
JAX's sort keys and tie-breaks: the same tree and chip give the same plan,
costs equal to the last bit (`tests/test_torch_planner.py`).

The leaves come in JAX's order (flax paths sorted key by key, as JAX's
tree flattens), each priced at its own dtype: a module on the ``meta``
device plans without weights (JAX's `eval_shape`), and a bf16 module is
priced at two bytes a parameter where JAX's f32 tree is priced at four.
A mapping of flax paths to tensors, arrays or shape objects plans too.

`refine_plans` is the measure-and-refine half: the top-k plans are placed
by their rules (`parallel.tensor.tensor_parallel_copy`) and timed
(`measure_forward_step`, `measure_train_step`); under a "model" group
every rank measures the same candidates in the same order and takes the
slowest rank's seconds, so every rank picks the same plan.

The pipeline half of JAX's planner (`StagePlan`, `plan_pipeline_stages`,
`build_stage_tree`, `default_num_microbatches`, `pipeline_bubble_terms`,
`MPMDTrainPlan`, `plan_mpmd_train_sharding`, and the "pipeline" axis of
`plan_train_sharding` and `search_train_meshes`) waits for
`PIPELINES`.
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "ChipSpec",
    "Workload",
    "LeafPlan",
    "PlanCost",
    "ShardingPlan",
    "CHIPS",
    "default_chip",
    "candidate_specs",
    "emit_rules",
    "plan_sharding",
    "plan_serving_sharding",
    "plan_train_sharding",
    "score_rules",
    "search_train_meshes",
    "measure_forward_step",
    "measure_train_step",
    "refine_plans",
    "resolve_sharding_rules",
]

#: The ROADMAP A item 3 bullet that ports the planner's pipeline half.
PIPELINES = "ROADMAP A item 3, pipelines (the planner's stage plans and the \"pipeline\" axis)"


# --------------------------------------------------------------------- chips
@dataclass(frozen=True)
class ChipSpec:
    """Per-chip bandwidth/compute constants the cost model prices against.

    The defaults are public TPU figures at the right order of magnitude —
    the planner ranks PLANS against each other on one chip, so only the
    RATIOS (HBM vs ICI vs FLOPs) matter; override per generation for honest
    absolute step-time predictions."""

    name: str = "tpu-v4"
    hbm_bytes: float = 32e9
    hbm_gbps: float = 1200.0  # HBM read bandwidth, GB/s
    ici_gbps: float = 300.0  # effective all-reduce bandwidth over ICI, GB/s
    tflops: float = 275.0  # bf16 matmul peak, TFLOP/s


CHIPS: Dict[str, ChipSpec] = {
    "tpu-v4": ChipSpec(),
    "tpu-v5e": ChipSpec("tpu-v5e", 16e9, 819.0, 180.0, 197.0),
    "tpu-v5p": ChipSpec("tpu-v5p", 95e9, 2765.0, 600.0, 459.0),
    # CPU smoke constants: only used so predicted-vs-measured numbers in the
    # bench are the right ballpark on the forced-device test meshes.
    "cpu-smoke": ChipSpec("cpu-smoke", 8e9, 10.0, 4.0, 0.05),
    # NVIDIA H100 SXM5 80GB (`NVIDIA H100 80GB HBM3` at 700.00 W), datasheet
    # figures: HBM3 at 3.35 TB/s, 989 dense bf16 TFLOP/s, NVLink 4 at 450 GB/s
    # a direction (a one-card machine cannot measure NVLink). `hbm_bytes` is
    # `torch.cuda.get_device_properties(0).total_memory` as read on the card.
    "h100-sxm": ChipSpec("h100-sxm", 85017493504.0, 3350.0, 450.0, 989.0),
}


def default_chip(device=None) -> ChipSpec:
    """Chip constants for `device`'s backend, as JAX picks them by backend:
    a CUDA device prices as the H100, the CPU with CPU-ish constants. With
    no device, the backend is the card when there is one."""
    if device is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    else:
        kind = torch.device(device).type
    return CHIPS["h100-sxm"] if kind == "cuda" else CHIPS["cpu-smoke"]


@dataclass(frozen=True)
class Workload:
    """What one dispatch looks like, for the cost model.

    ``batch``/``seq`` size the activation collectives (decode: slots x 1
    token; training: tokens per microbatch); ``kv_pool_bytes`` is the LOGICAL
    slot-cache footprint at the live cache dtype (sharded by KV head when
    ``kv_shardable``); ``opt_bytes_per_param`` adds optimizer state to the
    per-chip HBM account (Adam fp32 moments: 8.0; serving: 0)."""

    batch: int = 8
    seq: int = 1
    act_bytes: int = 2
    kv_pool_bytes: float = 0.0
    kv_shardable: bool = True
    opt_bytes_per_param: float = 0.0

    @property
    def is_training(self) -> bool:
        """Optimizer state in the account means a TRAINING dispatch: the step
        reads/writes moments and syncs gradients, both of which the cost model
        then prices (serving dispatches carry neither)."""
        return self.opt_bytes_per_param > 0.0


# --------------------------------------------------------------- plan output
@dataclass
class LeafPlan:
    """One parameter's chosen placement and its modeled contributions."""

    path: str
    shape: Tuple[int, ...]
    nbytes: float
    spec: Tuple
    local_bytes: float
    collective_bytes: float
    role: str  # "column-parallel" | "row-parallel" | "replicated" | ...
    # Optimizer-state placement for this leaf's moments (ZeRO weight-update
    # sharding: may shard along "data" even where the param replicates).
    # Equal to `spec` when the moments simply follow the parameter.
    opt_spec: Tuple = ()
    opt_local_bytes: float = 0.0


@dataclass
class PlanCost:
    """Analytic account of one full plan on one chip of the mesh."""

    per_chip_param_bytes: float
    per_chip_opt_bytes: float
    per_chip_kv_bytes: float
    collective_bytes: float  # ICI bytes per dispatch
    flop_time_s: float
    hbm_time_s: float
    ici_time_s: float
    step_time_s: float
    hbm_overflow_bytes: float

    @property
    def per_chip_total_bytes(self) -> float:
        return self.per_chip_param_bytes + self.per_chip_opt_bytes + self.per_chip_kv_bytes

    @property
    def total(self) -> float:
        """The beam-search objective: dispatch time (compute/HBM/ICI overlap
        as a max on TPU), a small additive bytes+traffic term so strictly
        smaller footprints win ties, and a dominating penalty for plans that
        do not fit per-chip HBM."""
        overflow_penalty = self.hbm_overflow_bytes * 1e3
        return self.step_time_s + 1e-3 * (self.hbm_time_s + self.ici_time_s) + overflow_penalty


@dataclass
class ShardingPlan:
    """The planner's product: a rules table in the shape every existing
    consumer (`spec_for_param`, `derive_tp_param_shardings`) already eats,
    plus the per-leaf placements and the modeled cost behind it."""

    rules: List[Tuple[str, Tuple]]
    leaves: List[LeafPlan]
    cost: PlanCost
    mesh_axes: Dict[str, int]
    chip: ChipSpec
    workload: Workload
    measured_step_s: Optional[float] = None
    #: Optimizer-state rules table, same `(pattern, spec)` shape, consumed by
    #: `derive_opt_state_shardings(..., opt_rules=...)`. Patterns are anchored
    #: `(^|/)` (not `^`) so they match the param path nested inside a moment
    #: path like ``0/mu/<param path>``. Empty when moments follow the params.
    opt_rules: List[Tuple[str, Tuple]] = field(default_factory=list)

    @property
    def leaf_specs(self) -> Dict[str, Tuple]:
        return {leaf.path: leaf.spec for leaf in self.leaves}

    @property
    def leaf_opt_specs(self) -> Dict[str, Tuple]:
        return {leaf.path: leaf.opt_spec for leaf in self.leaves}

    def describe(self) -> str:
        """Human-readable plan: per-leaf specs, the emitted rules table, and
        the predicted per-chip bytes / collective traffic / step time."""
        training = self.workload.is_training
        opt_col = f" {'opt spec':<22}" if training else ""
        lines = [
            f"sharding plan over mesh {self.mesh_axes} (chip model: {self.chip.name})",
            "",
            f"{'parameter':<52} {'shape':<18} {'spec':<22}{opt_col} {'role':<16} {'per-chip':>10}",
        ]
        for leaf in sorted(self.leaves, key=lambda l: l.path):
            opt_cell = f" {str(leaf.opt_spec):<22}" if training else ""
            lines.append(
                f"{leaf.path:<52} {str(tuple(leaf.shape)):<18} "
                f"{str(leaf.spec):<22}{opt_cell} {leaf.role:<16} {_fmt_bytes(leaf.local_bytes):>10}"
            )
        lines.append("")
        lines.append("emitted rules table (first match wins):")
        for pattern, spec in self.rules:
            lines.append(f"  ({pattern!r}, {spec!r})")
        if not self.rules:
            lines.append("  (empty — everything replicates)")
        if self.opt_rules:
            lines.append("")
            lines.append("emitted optimizer-state rules table (ZeRO weight-update sharding):")
            for pattern, spec in self.opt_rules:
                lines.append(f"  ({pattern!r}, {spec!r})")
        cost = self.cost
        lines += [
            "",
            f"predicted per-chip HBM: params {_fmt_bytes(cost.per_chip_param_bytes)}"
            + (f" + opt {_fmt_bytes(cost.per_chip_opt_bytes)}" if cost.per_chip_opt_bytes else "")
            + (f" + kv {_fmt_bytes(cost.per_chip_kv_bytes)}" if cost.per_chip_kv_bytes else "")
            + f" = {_fmt_bytes(cost.per_chip_total_bytes)}",
            f"predicted ICI traffic: {_fmt_bytes(cost.collective_bytes)}/dispatch",
            f"predicted step time: {cost.step_time_s * 1e6:.2f} us "
            f"(flops {cost.flop_time_s * 1e6:.2f} / hbm {cost.hbm_time_s * 1e6:.2f} / "
            f"ici {cost.ici_time_s * 1e6:.2f})",
        ]
        if self.measured_step_s is not None:
            lines.append(f"measured step time: {self.measured_step_s * 1e6:.2f} us")
        if cost.hbm_overflow_bytes:
            lines.append(
                f"WARNING: plan overflows per-chip HBM by {_fmt_bytes(cost.hbm_overflow_bytes)}"
            )
        return "\n".join(lines)

    def to_json(self) -> Dict[str, Any]:
        return {
            "mesh_axes": dict(self.mesh_axes),
            "chip": self.chip.name,
            "rules": [[pattern, list(spec)] for pattern, spec in self.rules],
            "opt_rules": [[pattern, list(spec)] for pattern, spec in self.opt_rules],
            "leaves": [
                {
                    "path": leaf.path,
                    "shape": list(leaf.shape),
                    "spec": list(leaf.spec),
                    "opt_spec": list(leaf.opt_spec),
                    "role": leaf.role,
                    "per_chip_bytes": int(leaf.local_bytes),
                    "opt_per_chip_bytes": int(leaf.opt_local_bytes),
                    "collective_bytes": int(leaf.collective_bytes),
                }
                for leaf in self.leaves
            ],
            "predicted": {
                "per_chip_param_bytes": int(self.cost.per_chip_param_bytes),
                "per_chip_opt_bytes": int(self.cost.per_chip_opt_bytes),
                "per_chip_kv_bytes": int(self.cost.per_chip_kv_bytes),
                "collective_bytes_per_dispatch": int(self.cost.collective_bytes),
                "step_time_s": self.cost.step_time_s,
                "hbm_overflow_bytes": int(self.cost.hbm_overflow_bytes),
            },
            "measured_step_s": self.measured_step_s,
        }


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GB"


# ----------------------------------------------------------- leaf harvesting
@dataclass
class _Leaf:
    path: str
    shape: Tuple[int, ...]
    nbytes: float
    elems: float


def _flat_leaves(params) -> List[Tuple[str, Tuple[int, ...], int, bool]]:
    """[(flax path, flax shape, bytes an element, floating)] of a module (its
    flax view, tied parameters once) or of a nested mapping, in the order
    JAX's tree flattens: keys sorted level by level."""
    from torch import nn

    from .sharding import flax_view, tree_paths_and_leaves

    if isinstance(params, nn.Module):
        named = dict(params.named_parameters())
        out = []
        for view in flax_view(params):
            t = named[view.name]
            out.append((view.path, view.flax_shape, t.element_size(), t.is_floating_point()))
    else:
        out = []
        for path, leaf in tree_paths_and_leaves(params):
            shape = tuple(int(d) for d in getattr(leaf, "shape", np.shape(leaf)))
            dtype = getattr(leaf, "dtype", np.float32)
            if isinstance(dtype, torch.dtype):
                size, floating = torch.empty((), dtype=dtype).element_size(), dtype.is_floating_point
            else:
                dtype = np.dtype(dtype)
                size, floating = dtype.itemsize, bool(np.issubdtype(dtype, np.floating))
            out.append((path, shape, size, floating))
    return sorted(out, key=lambda e: e[0].split("/"))


def _harvest_leaves(params, weight_dtype: str = "bf16") -> List[_Leaf]:
    """Flatten a module, or a params tree (tensors, arrays or shape objects),
    into planner leaves. ``weight_dtype="int8"`` prices every floating 2-D
    ``kernel`` leaf at its POST-quantization footprint (int8 entries + fp32
    per-output-channel scales, `ops/quantization.quantize_model_int8`), so
    predicted per-chip bytes track what the engine actually stores."""
    leaves = []
    for path, shape, itemsize, floating in _flat_leaves(params):
        shape = tuple(int(d) for d in shape)
        elems = float(np.prod(shape)) if shape else 1.0
        nbytes = elems * itemsize
        if (
            weight_dtype == "int8"
            and path.rsplit("/", 1)[-1] == "kernel"
            and len(shape) >= 2
            and floating
        ):
            nbytes = elems * 1 + shape[-1] * 4  # int8 entries + fp32 scales
        leaves.append(_Leaf(path=path, shape=shape, nbytes=nbytes, elems=elems))
    return leaves


def _axis_sizes(mesh) -> Dict[str, int]:
    """Axis-name -> size for a `DeviceMesh` OR a plain dict — the planner
    itself is pure shape arithmetic, so `accelerate-tpu-torch plan` can
    search a 64-chip layout from a laptop with ``mesh={"model": 64}``."""
    if isinstance(mesh, dict):
        return {name: int(size) for name, size in mesh.items()}
    return {name: int(size) for name, size in zip(mesh.mesh_dim_names, mesh.mesh.shape)}


# ----------------------------------------------------------- candidate space
def candidate_specs(path: str, shape: Sequence[int], mesh, axes: Sequence[str] = ("model",)):
    """All legal PartitionSpec tuples for one leaf: replicate, plus each
    single-axis placement on a divisible dim (column-parallel = last dim,
    row-parallel = first dim, and interior dims for stacked/conv weights).
    Divisibility-filtered with the same rule `_check_tp_divisible` enforces at
    placement time — a candidate this function returns can never hit the
    indivisible-rule hard error. 1-D leaves (norm scales, biases) only ever
    replicate: sharding them saves nothing and un-replicates the residual
    stream."""
    shape = tuple(int(d) for d in shape)
    cands: List[Tuple] = [()]
    if len(shape) < 2:
        return cands
    sizes = _axis_sizes(mesh)
    for axis in axes:
        n = sizes.get(axis, 1)
        if n <= 1:
            continue
        for dim, d in enumerate(shape):
            if d % n == 0 and d >= n:
                # Full-rank specs, trailing Nones KEPT: a row-parallel kernel
                # must emit (axis, None) — not (axis,) — because the
                # quantized-entry contract reads the rule's LAST entry as the
                # kernel's output axis (derive_tp_param_shardings: a
                # row-parallel kernel's per-output-channel scales replicate).
                spec = [None] * len(shape)
                spec[dim] = axis
                cand = tuple(spec)
                if cand not in cands:
                    cands.append(cand)
    return cands


def _spec_shard_factor(spec: Tuple, sizes: Dict[str, int]) -> int:
    factor = 1
    for entry in spec:
        if entry is None:
            continue
        parts = (entry,) if isinstance(entry, str) else tuple(entry)
        for axis in parts:
            factor *= sizes.get(axis, 1)
    return factor


# --------------------------------------------------------------- collectives
def _allreduce_bytes(payload: float, n: int) -> float:
    """Ring all-reduce wire bytes per chip: 2 (N-1)/N x payload."""
    return 2.0 * (n - 1) / n * payload if n > 1 else 0.0


def _allgather_bytes(payload: float, n: int) -> float:
    """Ring all-gather wire bytes per chip: (N-1)/N x payload."""
    return float(n - 1) / n * payload if n > 1 else 0.0


# --------------------------------------------------- structure (chains/roles)
#: Conventional output-projection names: the row-parallel end of a Megatron
#: column->row chain when shapes alone can't disambiguate (square attention
#: projections). Matched against the MODULE component of the path.
_OUT_PROJ_HINTS = (
    "wo",
    "w_down",
    "out_proj",
    "o_proj",
    "down_proj",
    "dense_4h_to_h",
    "fc_out",
    "fc2",
    "proj_out",
)

#: Input-side projections for the same convention (column-parallel end).
_IN_PROJ_HINTS = (
    "wq",
    "wk",
    "wv",
    "w_gate",
    "w_up",
    "q_proj",
    "k_proj",
    "v_proj",
    "query",
    "key",
    "value",
    "gate_proj",
    "up_proj",
    "dense_h_to_4h",
    "fc_in",
    "fc1",
)


def _module_name(path: str) -> str:
    parts = path.split("/")
    return parts[-2] if len(parts) >= 2 else parts[-1]


def _block_prefix(path: str) -> str:
    parts = path.split("/")
    return "/".join(parts[:-2]) if len(parts) >= 3 else ""


def _infer_hidden(leaves: Sequence[_Leaf]) -> Optional[int]:
    """The residual-stream width: the most common dimension across 2-D matmul
    kernels (it appears in every projection that reads or writes the
    residual)."""
    counts: Counter = Counter()
    for leaf in leaves:
        if len(leaf.shape) == 2 and leaf.path.rsplit("/", 1)[-1] == "kernel":
            counts.update(leaf.shape)
    if not counts:
        return None
    return counts.most_common(1)[0][0]


@dataclass
class _Cand:
    """One candidate for a group decision. ``opt_specs`` is the optimizer-state
    placement per leaf — ``None`` means the moments simply follow the param
    spec; a dict means the planner chose a distinct moment layout (ZeRO
    weight-update sharding along the data axis)."""

    label: str
    specs: Dict[str, Tuple]
    coll: float
    opt_specs: Optional[Dict[str, Tuple]] = None

    def opt_spec(self, path: str) -> Tuple:
        if self.opt_specs is not None:
            return self.opt_specs[path]
        return self.specs[path]


def _as_cand(candidate) -> _Cand:
    """Group builders construct plain (label, specs, coll) tuples; normalize
    them at the search boundary so opt-state-aware candidates and legacy
    3-tuples coexist."""
    if isinstance(candidate, _Cand):
        return candidate
    label, specs, coll = candidate
    return _Cand(label=label, specs=specs, coll=coll)


@dataclass
class _Group:
    """One beam-search decision: a Megatron chain (column producers + the row
    output projection), a lone matmul/embedding, or an unknown-role weight.
    ``candidates`` are (label, {path: spec}, collective_bytes) options (or
    `_Cand` objects once the training expansion has run)."""

    key: str
    leaves: List[_Leaf]
    candidates: List = field(default_factory=list)


def _build_groups(
    leaves: Sequence[_Leaf],
    mesh,
    axis: str,
    workload: Workload,
) -> List[_Group]:
    """Carve the parameter tree into independent decisions for the "model"
    axis: per-block Megatron chains, loner matmuls (lm_head), embedding
    tables, and conservative unknowns."""
    sizes = _axis_sizes(mesh)
    n = sizes.get(axis, 1)
    hidden = _infer_hidden(leaves)

    kernels_2d = [
        l for l in leaves if len(l.shape) == 2 and l.path.rsplit("/", 1)[-1] == "kernel"
    ]
    embeddings = [
        l for l in leaves if l.path.rsplit("/", 1)[-1] == "embedding" and len(l.shape) == 2
    ]
    known = {l.path for l in kernels_2d} | {l.path for l in embeddings}
    others = [l for l in leaves if l.path not in known]

    groups: List[_Group] = []
    by_block: Dict[str, List[_Leaf]] = {}
    for leaf in kernels_2d:
        by_block.setdefault(_block_prefix(leaf.path), []).append(leaf)

    loners: List[_Leaf] = []
    for block, members in sorted(by_block.items()):
        members = sorted(members, key=lambda l: l.path)
        out_proj = _pick_out_proj(members, hidden)
        if out_proj is None or len(members) < 2:
            loners.extend(members)
            continue
        columns = [l for l in members if l.path != out_proj.path]
        # Chain legality: every member divisible on its chain dim.
        legal = out_proj.shape[0] % n == 0 and all(c.shape[-1] % n == 0 for c in columns)
        cands: List[Tuple[str, Dict[str, Tuple], float]] = [
            ("replicate", {l.path: () for l in members}, 0.0)
        ]
        if n > 1 and legal:
            specs = {c.path: (None, axis) for c in columns}
            # (axis, None), full rank: the trailing None is load-bearing —
            # the quantized-scale derivation reads the rule's LAST entry as
            # the output axis, and a row-parallel kernel's scales replicate.
            specs[out_proj.path] = (axis, None)
            # One all-reduce of the block's residual write per dispatch: the
            # column outputs flow into the row contraction sharded, the row
            # output is partial-summed across the axis.
            residual_bytes = float(
                workload.batch * workload.seq * out_proj.shape[-1] * workload.act_bytes
            )
            cands.append(("megatron", specs, _allreduce_bytes(residual_bytes, n)))
        groups.append(_Group(key=f"chain:{block}", leaves=members, candidates=cands))

    for leaf in loners + embeddings:
        groups.append(_loner_group(leaf, mesh, axis, workload, hidden))

    for leaf in others:
        groups.append(_unknown_group(leaf, mesh, axis))
    return groups


def _pick_out_proj(members: List[_Leaf], hidden: Optional[int]) -> Optional[_Leaf]:
    """The block's row-parallel end: a kernel writing the residual (dout ==
    hidden) whose INPUT is another member's output. Structural match first
    (din != hidden pins it uniquely — MLP down-projections); the conventional
    name hints break the tie for square attention projections. None when the
    block has no recognizable chain — those weights are planned as loners."""
    if hidden is None:
        return None
    douts = {l.shape[-1] for l in members}
    structural = [
        l
        for l in members
        if l.shape[-1] == hidden and l.shape[0] != hidden and l.shape[0] in douts
    ]
    if len(structural) == 1:
        return structural[0]
    hinted = [
        l
        for l in members
        if l.shape[-1] == hidden
        and _module_name(l.path) in _OUT_PROJ_HINTS
        and l.shape[0] in douts
    ]
    if len(hinted) == 1 and all(
        _module_name(l.path) in _IN_PROJ_HINTS for l in members if l.path != hinted[0].path
    ):
        return hinted[0]
    return None


def _loner_group(leaf: _Leaf, mesh, axis: str, workload: Workload, hidden: Optional[int]) -> _Group:
    """A matmul/embedding with no chain partner. Column-parallel replays its
    output through an all-gather (the consumer reads replicated); row-parallel
    partial-sums through an all-reduce; an embedding GATHER sharded on the
    vocab dim all-reduces the masked lookup, sharded on the feature dim it
    all-gathers the rows."""
    sizes = _axis_sizes(mesh)
    n = sizes.get(axis, 1)
    tokens = float(workload.batch * workload.seq)
    is_embedding = leaf.path.rsplit("/", 1)[-1] == "embedding"
    cands: List[Tuple[str, Dict[str, Tuple], float]] = [("replicate", {leaf.path: ()}, 0.0)]
    if n > 1 and len(leaf.shape) == 2:
        din, dout = leaf.shape
        out_bytes = tokens * dout * workload.act_bytes
        if is_embedding:
            # [vocab, features]: dim 0 = gather dim, dim 1 = row features.
            feat_bytes = tokens * dout * workload.act_bytes
            if din % n == 0:
                cands.append(
                    ("row-parallel", {leaf.path: (axis, None)}, _allreduce_bytes(feat_bytes, n))
                )
            if dout % n == 0:
                cands.append(
                    ("column-parallel", {leaf.path: (None, axis)}, _allgather_bytes(feat_bytes, n))
                )
        else:
            if dout % n == 0:
                cands.append(
                    ("column-parallel", {leaf.path: (None, axis)}, _allgather_bytes(out_bytes, n))
                )
            if din % n == 0:
                cands.append(
                    ("row-parallel", {leaf.path: (axis, None)}, _allreduce_bytes(out_bytes, n))
                )
    return _Group(key=f"loner:{leaf.path}", leaves=[leaf], candidates=cands)


def _unknown_group(leaf: _Leaf, mesh, axis: str) -> _Group:
    """A weight the planner can't place in a dataflow role (conv filters,
    stacked expert tensors, 1-D scales). Sharding it is costed as one
    all-gather of the weight itself per dispatch — the GSPMD worst case for a
    replicated-activation read — so these replicate unless they are so large
    that even re-gathering beats holding N copies."""
    sizes = _axis_sizes(mesh)
    n = sizes.get(axis, 1)
    cands: List[Tuple[str, Dict[str, Tuple], float]] = [("replicate", {leaf.path: ()}, 0.0)]
    if n > 1 and len(leaf.shape) >= 2:
        dims = sorted(
            (d for d, size in enumerate(leaf.shape) if size % n == 0 and size >= n),
            key=lambda d: -leaf.shape[d],
        )
        if dims:
            dim = dims[0]
            spec = [None] * len(leaf.shape)
            spec[dim] = axis
            cands.append(("sharded-regather", {leaf.path: tuple(spec)}, _allgather_bytes(leaf.nbytes, n)))
    return _Group(key=f"unknown:{leaf.path}", leaves=[leaf], candidates=cands)


def _fsdp_groups(leaves: Sequence[_Leaf], mesh, workload: Workload) -> List[_Group]:
    """Per-leaf ZeRO-3 decisions on the "fsdp" axis: keep a full replica and
    all-reduce gradients, or shard the storage (params + moments 1/N) and
    pay per-step all-gathers (fwd + bwd) plus the reduce-scatter — the
    weight-update-sharding account from PAPERS.md."""
    from .sharding import _fsdp_dim

    sizes = _axis_sizes(mesh)
    n = sizes.get("fsdp", 1)
    groups = []
    for leaf in leaves:
        cands: List[Tuple[str, Dict[str, Tuple], float]] = [
            ("replicate", {leaf.path: ()}, _allreduce_bytes(leaf.nbytes, n))
        ]
        dim = _fsdp_dim(leaf.path, leaf.shape, n, set())
        if n > 1 and dim is not None:
            spec = [None] * len(leaf.shape)
            spec[dim] = "fsdp"
            cands.append(
                ("fsdp", {leaf.path: tuple(spec)}, 3.0 * _allgather_bytes(leaf.nbytes, n))
            )
        groups.append(_Group(key=f"fsdp:{leaf.path}", leaves=[leaf], candidates=cands))
    return groups


# ----------------------------------------------------- ZeRO (training) axis
#: Moments smaller than this replicate regardless: sharding a norm scale's
#: Adam state saves a few hundred bytes and costs a scattered layout. Smaller
#: than sharding._SMALL_PARAM_DEFAULT on purpose — the CPU test tier plans
#: tiny models whose kernels must still exercise the ZeRO path.
_ZERO_MIN_ELEMS = 1024


def _zero_opt_spec(
    path: str, shape: Tuple[int, ...], param_spec: Tuple, sizes: Dict[str, int], zero_axis: str
) -> Optional[Tuple]:
    """Extend a param spec with ``zero_axis`` for the MOMENT placement: grow an
    already-sharded dim when the finer grid still divides (keeps the moment
    shard nested inside the param shard), else take the same free dim
    `spec_for_param`'s fsdp extension would pick. Full-rank tuple (trailing
    Nones kept, planner canon); None when no dim divides."""
    from .sharding import _fsdp_dim

    n = sizes.get(zero_axis, 1)
    if n <= 1 or not shape:
        return None
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))
    taken = {i for i, s in enumerate(spec) if s is not None}
    for i in sorted(taken, reverse=True):
        axes = (spec[i],) if isinstance(spec[i], str) else tuple(spec[i])
        group = n * int(np.prod([sizes.get(a, 1) for a in axes]))
        if shape[i] % group == 0 and shape[i] >= group:
            spec[i] = tuple(axes) + (zero_axis,)
            return tuple(spec)
    dim = _fsdp_dim(path, shape, n, taken)
    if dim is None:
        return None
    spec[dim] = zero_axis
    return tuple(spec)


def _train_extend_candidates(
    group: _Group, sizes: Dict[str, int], workload: Workload, zero_axis: Optional[str]
) -> None:
    """Rewrite a group's candidates for a TRAINING mesh with a data axis:

    - every candidate is charged the per-step gradient synchronization over
      "data" (an all-reduce of the leaf's local gradient — grads carry the
      param sharding, so the payload is the param's per-chip bytes);
    - each candidate gains a "+zero" twin whose optimizer moments additionally
      shard along the data axis. The ZeRO update's reduce-scatter + updated-
      param all-gather moves exactly the same wire bytes as the plain grad
      all-reduce (2(N-1)/N each), so the ICI term is UNCHANGED — the twin wins
      purely on per-chip HBM, which is the Xu et al. weight-update-sharding
      account.
    """
    data_n = sizes.get("data", 1)
    out: List[_Cand] = []
    for candidate in group.candidates:
        cand = _as_cand(candidate)
        grad_sync = 0.0
        if data_n > 1 and workload.is_training:
            for leaf in group.leaves:
                local = leaf.nbytes / _spec_shard_factor(cand.specs[leaf.path], sizes)
                grad_sync += _allreduce_bytes(local, data_n)
        base = _Cand(cand.label, cand.specs, cand.coll + grad_sync, cand.opt_specs)
        out.append(base)
        if zero_axis is None:
            continue
        opt_specs: Dict[str, Tuple] = {}
        changed = False
        for leaf in group.leaves:
            pspec = cand.specs[leaf.path]
            zspec = None
            if leaf.elems >= _ZERO_MIN_ELEMS:
                zspec = _zero_opt_spec(leaf.path, leaf.shape, pspec, sizes, zero_axis)
            if zspec is not None and zspec != tuple(pspec):
                opt_specs[leaf.path] = zspec
                changed = True
            else:
                opt_specs[leaf.path] = pspec
        if changed:
            out.append(_Cand(base.label + "+zero", cand.specs, base.coll, opt_specs))
    group.candidates = out


# --------------------------------------------------------------- beam search
def _score(
    local_param_bytes: float,
    local_elems: float,
    ici_bytes: float,
    chip: ChipSpec,
    workload: Workload,
    kv_factor: int,
    local_opt_bytes: Optional[float] = None,
) -> PlanCost:
    per_chip_kv = workload.kv_pool_bytes / max(kv_factor, 1)
    # Spec-DEPENDENT optimizer-state account: the beam search passes the bytes
    # implied by each candidate's moment placement (ZeRO shards may divide the
    # data axis where the param replicates). The None default prices moments
    # as following the param sharding — the pre-2D behavior, and what a rules
    # table without an opt-rules twin actually places.
    per_chip_opt = (
        local_opt_bytes if local_opt_bytes is not None
        else local_elems * workload.opt_bytes_per_param
    )
    flop_time = 2.0 * local_elems * workload.batch * workload.seq / (chip.tflops * 1e12)
    # A training step reads AND writes the moments next to the params; serving
    # dispatches (opt == 0) price exactly as before.
    hbm_time = (local_param_bytes + per_chip_kv + per_chip_opt) / (chip.hbm_gbps * 1e9)
    ici_time = ici_bytes / (chip.ici_gbps * 1e9)
    step = max(flop_time, hbm_time, ici_time)
    total_bytes = local_param_bytes + per_chip_opt + per_chip_kv
    overflow = max(0.0, total_bytes - chip.hbm_bytes)
    return PlanCost(
        per_chip_param_bytes=local_param_bytes,
        per_chip_opt_bytes=per_chip_opt,
        per_chip_kv_bytes=per_chip_kv,
        collective_bytes=ici_bytes,
        flop_time_s=flop_time,
        hbm_time_s=hbm_time,
        ici_time_s=ici_time,
        step_time_s=step,
        hbm_overflow_bytes=overflow,
    )


@dataclass
class _Partial:
    choices: Tuple[int, ...]
    local_bytes: float
    local_elems: float
    ici_bytes: float
    local_opt_bytes: float = 0.0


def _beam_search(
    groups: List[_Group],
    sizes: Dict[str, int],
    chip: ChipSpec,
    workload: Workload,
    kv_factor: int,
    beam_width: int,
    top_k: int,
) -> List[Tuple[Dict[str, Tuple], Dict[str, Tuple], Dict[str, str], float, PlanCost]]:
    """Beam over group decisions (largest groups first so early pruning sees
    the decisions that matter). Returns up to ``top_k`` distinct complete
    (param assignment, opt assignment, roles, ici, cost) tuples ranked by
    modeled cost."""
    for group in groups:
        group.candidates = [_as_cand(c) for c in group.candidates]
    order = sorted(range(len(groups)), key=lambda i: -sum(l.nbytes for l in groups[i].leaves))
    beam = [_Partial(choices=(), local_bytes=0.0, local_elems=0.0, ici_bytes=0.0)]
    opt_bpp = workload.opt_bytes_per_param
    for gi in order:
        group = groups[gi]
        nxt: List[_Partial] = []
        for partial in beam:
            for ci, cand in enumerate(group.candidates):
                add_bytes = 0.0
                add_elems = 0.0
                add_opt = 0.0
                for leaf in group.leaves:
                    factor = _spec_shard_factor(cand.specs[leaf.path], sizes)
                    add_bytes += leaf.nbytes / factor
                    add_elems += leaf.elems / factor
                    if opt_bpp:
                        opt_factor = _spec_shard_factor(cand.opt_spec(leaf.path), sizes)
                        add_opt += leaf.elems * opt_bpp / opt_factor
                nxt.append(
                    _Partial(
                        choices=partial.choices + (ci,),
                        local_bytes=partial.local_bytes + add_bytes,
                        local_elems=partial.local_elems + add_elems,
                        ici_bytes=partial.ici_bytes + cand.coll,
                        local_opt_bytes=partial.local_opt_bytes + add_opt,
                    )
                )
        nxt.sort(
            key=lambda p: _score(
                p.local_bytes, p.local_elems, p.ici_bytes, chip, workload, kv_factor,
                local_opt_bytes=p.local_opt_bytes if opt_bpp else None,
            ).total
        )
        beam = nxt[: max(beam_width, top_k)]

    results = []
    seen = set()
    for partial in beam:
        assignment: Dict[str, Tuple] = {}
        opt_assignment: Dict[str, Tuple] = {}
        roles: Dict[str, str] = {}
        for pos, gi in enumerate(order):
            cand = groups[gi].candidates[partial.choices[pos]]
            for leaf in groups[gi].leaves:
                spec = cand.specs[leaf.path]
                opt_spec = cand.opt_spec(leaf.path)
                assignment[leaf.path] = spec
                opt_assignment[leaf.path] = opt_spec
                if spec:
                    roles[leaf.path] = cand.label
                elif opt_spec and opt_spec != tuple(spec):
                    roles[leaf.path] = "zero-opt"
                else:
                    roles[leaf.path] = "replicated"
        key = tuple(sorted(assignment.items())) + tuple(sorted(opt_assignment.items()))
        if key in seen:
            continue
        seen.add(key)
        cost = _score(
            partial.local_bytes, partial.local_elems, partial.ici_bytes, chip, workload,
            kv_factor, local_opt_bytes=partial.local_opt_bytes if opt_bpp else None,
        )
        results.append((assignment, opt_assignment, roles, partial.ici_bytes, cost))
        if len(results) >= top_k:
            break
    return results


# ------------------------------------------------------------- rule emission
#: Suffix components that are storage details of a leaf, not module identity:
#: patterns anchor on the MODULE component so quantized {"q","scale"} entries
#: keep riding their kernel's rule (`derive_tp_param_shardings` contract).
def _rule_suffix(path: str) -> str:
    parts = path.split("/")
    return "/".join(parts[-2:]) if len(parts) >= 2 else path


def emit_rules(assignment: Dict[str, Tuple], path_anchor: str = "^") -> List[Tuple[str, Tuple]]:
    """Collapse per-leaf spec choices into a `(pattern, spec)` table in the
    exact shape `spec_for_param` / `derive_tp_param_shardings` consume.

    Sharded leaves group by their last-two-component suffix (``wq/kernel``)
    when every leaf sharing that suffix agrees on the spec — the emitted
    pattern ``(^|/)wq/kernel(/|$)`` then also covers the quantized
    ``.../kernel/q`` / ``.../kernel/scale`` entries, exactly like the hand
    tables. Conflicting suffixes fall back to full-path anchored rules,
    emitted FIRST so first-match-wins keeps them authoritative. Replicated
    leaves need no rule: unmatched leaves replicate by construction.

    ``path_anchor`` is the full-path rules' start anchor: the default ``^``
    for param tables; optimizer-state tables pass ``(^|/)`` so the pattern
    still matches the param path nested inside a moment path (``0/mu/<path>``)."""
    by_suffix: Dict[str, Dict[str, Tuple]] = {}
    for path, spec in assignment.items():
        by_suffix.setdefault(_rule_suffix(path), {})[path] = spec

    exact: List[Tuple[str, Tuple]] = []
    grouped: List[Tuple[str, Tuple]] = []
    for suffix in sorted(by_suffix):
        specs = by_suffix[suffix]
        chosen = set(specs.values())
        sharded = {p: s for p, s in specs.items() if any(e is not None for e in s)}
        if not sharded:
            continue
        if len(chosen) == 1:
            grouped.append((f"(^|/){re.escape(suffix)}(/|$)", next(iter(chosen))))
        else:
            for path in sorted(sharded):
                exact.append((f"{path_anchor}{re.escape(path)}(/|$)", sharded[path]))
    return exact + grouped


# ------------------------------------------------------------------ planning
def plan_sharding(
    params,
    mesh,
    *,
    axes: Optional[Sequence[str]] = None,
    chip: Optional[ChipSpec] = None,
    workload: Optional[Workload] = None,
    weight_dtype: str = "bf16",
    beam_width: int = 8,
    top_k: int = 1,
):
    """Search a sharding strategy for ``params`` on ``mesh``.

    Returns the best `ShardingPlan` (or the ranked top-k list when
    ``top_k > 1`` — feed those to `refine_plans` for measure-and-refine).
    ``axes`` defaults to every supported mesh axis with size > 1: "model"
    gets the Megatron chain/loner dataflow model, "fsdp" the ZeRO-3
    storage-vs-regather account, and "data" (with a TRAINING workload, i.e.
    ``opt_bytes_per_param > 0``) the ZeRO weight-update-sharding account —
    per-leaf optimizer-moment placement along the data axis, priced
    spec-dependently in HBM while the grad-sync ICI bytes stay those of the
    plain all-reduce (reduce-scatter + all-gather moves the same wire bytes).
    `params` may be real arrays or `ShapeDtypeStruct`s (`jax.eval_shape`) —
    the planner only reads shapes and dtypes.

    Binding semantics: sharded decisions bind everywhere (an emitted rule
    always wins in `spec_for_param`); REPLICATE decisions bind except where
    an `fsdp_plugin` explicitly requests parameter sharding — the deriver's
    fsdp policy governs rule-unmatched leaves, which is why the Accelerator
    seam plans ``axes=("model",)`` and leaves ZeRO to the plugin the user
    configured. Plan the "fsdp" axis directly only for plugin-free placement
    (rules consumed on their own)."""
    if isinstance(chip, str):
        chip = CHIPS[chip]
    chip = chip or default_chip()
    workload = workload or Workload()
    sizes = _axis_sizes(mesh)
    if axes is None:
        axes = [a for a in ("data", "model", "fsdp") if sizes.get(a, 1) > 1]

    leaves = _harvest_leaves(params, weight_dtype=weight_dtype)
    groups: List[_Group] = []
    if "model" in axes:
        groups += _build_groups(leaves, mesh, "model", workload)
    if "fsdp" in axes and "model" not in axes:
        groups += _fsdp_groups(leaves, mesh, workload)
    elif "fsdp" in axes:
        # Megatron + ZeRO composition rides the existing spec_for_param
        # extension (the rule's dim grows ("model","fsdp")) — the planner
        # decides the model-axis layout and leaves the fsdp extension to the
        # deriver rather than double-counting it here.
        pass
    if not groups:
        groups = [_Group(key=f"leaf:{l.path}", leaves=[l], candidates=[("replicate", {l.path: ()}, 0.0)]) for l in leaves]

    # Training meshes with a data axis: charge every candidate the grad sync
    # and enumerate the ZeRO optimizer-state twin (moments sharded over
    # "data" even where params replicate).
    if "data" in axes and sizes.get("data", 1) > 1 and workload.is_training:
        for group in groups:
            _train_extend_candidates(group, sizes, workload, zero_axis="data")

    kv_factor = sizes.get("model", 1) if workload.kv_shardable else 1
    ranked = _beam_search(groups, sizes, chip, workload, kv_factor, beam_width, top_k)

    opt_bpp = workload.opt_bytes_per_param
    plans = []
    for assignment, opt_assignment, roles, ici_bytes, cost in ranked:
        leaf_plans = [
            LeafPlan(
                path=leaf.path,
                shape=leaf.shape,
                nbytes=leaf.nbytes,
                spec=assignment[leaf.path],
                local_bytes=leaf.nbytes / _spec_shard_factor(assignment[leaf.path], sizes),
                collective_bytes=0.0,
                role=roles[leaf.path],
                opt_spec=opt_assignment[leaf.path],
                opt_local_bytes=(
                    leaf.elems * opt_bpp
                    / _spec_shard_factor(opt_assignment[leaf.path], sizes)
                ),
            )
            for leaf in leaves
        ]
        # The opt-rules table covers EVERY sharded moment (including the ones
        # that just follow a sharded param): derive_opt_state_shardings treats
        # it as authoritative when present, so an omitted follow-the-param
        # rule would silently replicate that moment and reshard every step.
        opt_rules = (
            emit_rules(opt_assignment, path_anchor="(^|/)")
            if any(opt_assignment[l.path] != assignment[l.path] for l in leaves)
            else []
        )
        plans.append(
            ShardingPlan(
                rules=emit_rules(assignment),
                leaves=leaf_plans,
                cost=cost,
                mesh_axes=sizes,
                chip=chip,
                workload=workload,
                opt_rules=opt_rules,
            )
        )
    if not plans:
        raise ValueError("planner produced no candidate plans (empty params tree?)")
    return plans[0] if top_k == 1 else plans


def score_rules(
    params,
    mesh,
    rules: Sequence[Tuple[str, Tuple]],
    *,
    chip: Optional[ChipSpec] = None,
    workload: Optional[Workload] = None,
    weight_dtype: str = "bf16",
) -> ShardingPlan:
    """Price an EXISTING rules table (e.g. a hand-written family table) with
    the same cost model the planner uses — the apples-to-apples comparison
    behind `accelerate-tpu plan --against-rules` and the planner-vs-hand
    bench A/B. Collective bytes are modeled by re-deriving each rule-matched
    leaf's role through the planner's group structure."""
    if isinstance(chip, str):
        chip = CHIPS[chip]
    chip = chip or default_chip()
    workload = workload or Workload()
    sizes = _axis_sizes(mesh)
    leaves = _harvest_leaves(params, weight_dtype=weight_dtype)

    assignment: Dict[str, Tuple] = {}
    for leaf in leaves:
        spec: Tuple = ()
        for pattern, rule_spec in rules or []:
            if re.search(pattern, leaf.path):
                # Normalize to the planner's full-rank canonical form so hand
                # rules like ("model",) and ("model", None) price identically.
                padded = tuple(rule_spec)[: len(leaf.shape)]
                padded = padded + (None,) * (len(leaf.shape) - len(padded))
                spec = () if all(e is None for e in padded) else padded
                break
        assignment[leaf.path] = spec

    # Reuse the group construction to price collectives for this assignment:
    # each group contributes the candidate whose specs match the assignment,
    # or a conservative regather when the assignment is not one the model
    # recognizes.
    groups = _build_groups(leaves, mesh, "model", workload)
    ici_bytes = 0.0
    roles: Dict[str, str] = {p: "replicated" for p in assignment}
    local_bytes = 0.0
    local_elems = 0.0
    for leaf in leaves:
        factor = _spec_shard_factor(assignment[leaf.path], sizes)
        local_bytes += leaf.nbytes / factor
        local_elems += leaf.elems / factor
    for group in groups:
        matched = None
        for candidate in group.candidates:
            cand = _as_cand(candidate)
            if all(assignment.get(p, ()) == s for p, s in cand.specs.items()):
                matched = (cand.label, cand.coll)
                break
        if matched is None:
            # Off-model assignment: conservative regather of each sharded leaf.
            coll = sum(
                _allgather_bytes(l.nbytes, _spec_shard_factor(assignment[l.path], sizes))
                for l in group.leaves
                if assignment[l.path]
            )
            matched = ("off-model", coll)
        label, coll = matched
        ici_bytes += coll
        for leaf in group.leaves:
            roles[leaf.path] = label if assignment[leaf.path] else "replicated"

    # Training dispatches sync gradients over "data" — price the hand table's
    # all-reduce the same way _train_extend_candidates prices the planner's
    # candidates, or the comparison silently favors whichever side skipped it.
    data_n = sizes.get("data", 1)
    if data_n > 1 and workload.is_training:
        for leaf in leaves:
            local = leaf.nbytes / _spec_shard_factor(assignment[leaf.path], sizes)
            ici_bytes += _allreduce_bytes(local, data_n)

    kv_factor = sizes.get("model", 1) if workload.kv_shardable else 1
    cost = _score(local_bytes, local_elems, ici_bytes, chip, workload, kv_factor)
    leaf_plans = [
        LeafPlan(
            path=leaf.path,
            shape=leaf.shape,
            nbytes=leaf.nbytes,
            spec=assignment[leaf.path],
            local_bytes=leaf.nbytes / _spec_shard_factor(assignment[leaf.path], sizes),
            collective_bytes=0.0,
            role=roles[leaf.path],
            # A bare rules table carries no opt-state twin: moments follow the
            # param placement, which is how _score priced them above.
            opt_spec=assignment[leaf.path],
            opt_local_bytes=(
                leaf.elems * workload.opt_bytes_per_param
                / _spec_shard_factor(assignment[leaf.path], sizes)
            ),
        )
        for leaf in leaves
    ]
    return ShardingPlan(
        rules=list(rules or []),
        leaves=leaf_plans,
        cost=cost,
        mesh_axes=sizes,
        chip=chip,
        workload=workload,
    )


# ------------------------------------------------------------------- serving
def plan_serving_sharding(
    params,
    mesh,
    config,
    *,
    num_slots: int,
    padded_length: int,
    paged: bool,
    page_size: int = 0,
    num_pages: int = 0,
    kv_cache_dtype: str = "bf16",
    weight_dtype: str = "bf16",
    chip: Optional[ChipSpec] = None,
    beam_width: int = 8,
    top_k: int = 1,
):
    """Plan the tensor-parallel decode layout for a serving engine: the
    "model"-axis search over the params tree with the engine's KV pool priced
    into per-chip HBM at the LIVE cache dtype (quantized pools add their
    per-page-per-head scale arrays). This is what
    ``ContinuousBatcher(tp=N, sharding_rules="auto")`` calls."""
    kv_heads = getattr(config, "num_key_value_heads", None) or config.num_attention_heads
    head_dim = getattr(config, "head_dim", None) or (
        config.hidden_size // config.num_attention_heads
    )
    layers = config.num_hidden_layers
    kv_bytes_per_elem = {"bf16": 2.0, "int8": 1.0, "fp8_e4m3": 1.0}.get(kv_cache_dtype, 2.0)
    if paged:
        kv_elems = 2.0 * layers * num_pages * page_size * kv_heads * head_dim
        scale_bytes = (
            2.0 * layers * num_pages * kv_heads * 4.0 if kv_cache_dtype != "bf16" else 0.0
        )
    else:
        kv_elems = 2.0 * layers * num_slots * padded_length * kv_heads * head_dim
        scale_bytes = 0.0
    workload = Workload(
        batch=num_slots,
        seq=1,
        act_bytes=2,
        kv_pool_bytes=kv_elems * kv_bytes_per_elem + scale_bytes,
        kv_shardable=kv_heads % max(_axis_sizes(mesh).get("model", 1), 1) == 0,
        opt_bytes_per_param=0.0,
    )
    return plan_sharding(
        params,
        mesh,
        axes=("model",),
        chip=chip,
        workload=workload,
        weight_dtype=weight_dtype,
        beam_width=beam_width,
        top_k=top_k,
    )


# ------------------------------------------------------------------ training
def plan_train_sharding(
    params,
    mesh,
    *,
    batch: int,
    seq: int,
    act_bytes: int = 2,
    opt_bytes_per_param: float = 8.0,
    weight_dtype: str = "bf16",
    chip: Optional[ChipSpec] = None,
    beam_width: int = 8,
    top_k: int = 1,
    layered_split=None,
    num_microbatches: Optional[int] = None,
):
    """Plan the training layout for ``mesh``.

    On a 2D ("data", "model") mesh: the params tree searched over both axes
    with gradient all-reduce priced per candidate and a ZeRO-style twin per
    candidate whose optimizer moments shard along "data" even where the params
    replicate (Xu et al.: reduce-scatter + all-gather moves the same ICI bytes
    as the all-reduce, so the twin wins purely on per-chip HBM). This is what
    ``Accelerator.prepare(sharding_rules="auto")`` calls on a training mesh.

    A mesh with a "pipeline" axis above 1 (JAX's MPMD stage plans) and
    ``layered_split`` raise: they wait for `PIPELINES`."""
    sizes = _axis_sizes(mesh)
    if sizes.get("pipeline", 1) > 1 or layered_split is not None or num_microbatches is not None:
        raise NotImplementedError(
            f"plan_train_sharding over a \"pipeline\" axis (layered_split, per-stage plans) waits for {PIPELINES}")
    axes = tuple(a for a in ("data", "model") if sizes.get(a, 1) > 1) or ("model",)
    workload = Workload(
        batch=batch,
        seq=seq,
        act_bytes=act_bytes,
        opt_bytes_per_param=opt_bytes_per_param,
    )
    return plan_sharding(
        params,
        mesh,
        axes=axes,
        chip=chip,
        workload=workload,
        weight_dtype=weight_dtype,
        beam_width=beam_width,
        top_k=top_k,
    )


def search_train_meshes(
    params,
    devices,
    *,
    batch: int,
    seq: int,
    layered_split=None,
    act_bytes: int = 2,
    opt_bytes_per_param: float = 8.0,
    weight_dtype: str = "bf16",
    chip: Optional[ChipSpec] = None,
    beam_width: int = 8,
    max_pipeline: Optional[int] = None,
):
    """Search the ("data", "model") mesh product at pipeline=1: every
    factorization of the device count (`devices`, a sequence or a count)
    planned with `plan_train_sharding`, ``[(mesh_axes, plan)]`` ranked by
    modeled cost. This is JAX's search without ``layered_split``, whose
    pipeline candidates it skips; ``layered_split`` raises (`PIPELINES`).
    Each plan's mesh is the `ParallelismConfig`'s whole axis table, as JAX's
    `build_mesh` gives it."""
    from ..utils.dataclasses import ParallelismConfig

    if layered_split is not None:
        raise NotImplementedError(f"search_train_meshes over pipeline candidates waits for {PIPELINES}")
    n = devices if isinstance(devices, int) else len(list(devices))
    results = []
    for model_deg in (d for d in range(1, n + 1) if n % d == 0):
        data_deg = n // model_deg
        mesh = ParallelismConfig(data=data_deg, model=model_deg, pipeline=1).resolve(n)
        try:
            plan = plan_train_sharding(
                params,
                mesh,
                batch=batch,
                seq=seq,
                act_bytes=act_bytes,
                opt_bytes_per_param=opt_bytes_per_param,
                weight_dtype=weight_dtype,
                chip=chip,
                beam_width=beam_width,
            )
        except ValueError:
            continue
        results.append(({"data": data_deg, "model": model_deg, "pipeline": 1}, plan))
    results.sort(key=lambda pair: pair[1].cost.total)
    return results


# ---------------------------------------------------------- measure & refine
def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _slowest(seconds: float, device: torch.device, group, size: int) -> float:
    """`seconds` as the slowest of the `size` ranks of `group` (a process
    group, None for every process) measured it: a MAX all-reduce, counted
    with the blocks' collectives, so every rank picks the same plan;
    `seconds` itself for one rank."""
    if size == 1:
        return seconds
    import torch.distributed as dist

    from .tensor import COLLECTIVES

    COLLECTIVES["all_reduce"] += 1
    t = torch.tensor([seconds], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def measure_forward_step(
    module,
    tp,
    rules: Sequence[Tuple[str, Tuple]],
    *,
    batch: int = 1,
    repeats: int = 3,
    device=None,
) -> float:
    """Wall-time one single-token forward of `module` placed by ``rules``
    over the "model" group `tp` (a `parallel.tensor.TPGroup`, or None at one
    process): this rank's split, `parallel.tensor.tensor_parallel_copy`, on
    `device` (``cuda`` unless the caller passes ``"cpu"``) — the default
    measurement `refine_plans` uses. The first call runs outside the timer
    and the device is synchronized around each; returns best-of-``repeats``
    seconds (best-of, not mean: scheduling noise only ever ADDS time), the
    slowest rank's under a group."""
    import time

    from ..device import resolve_device
    from ..serving import _on_device
    from .tensor import tensor_parallel_copy

    device = resolve_device(device)
    placed = _on_device(tensor_parallel_copy(module, list(rules), tp), device)
    ids = torch.zeros((batch, 1), dtype=torch.long, device=device)
    with torch.no_grad():
        placed(ids)  # the first call (GEMM handles, kernel builds) outside the timed region
        _synchronize(device)
        best = float("inf")
        for _ in range(max(1, repeats)):
            start = time.perf_counter()
            placed(ids)
            _synchronize(device)
            best = min(best, time.perf_counter() - start)
    del placed
    return best if tp is None else _slowest(best, device, tp.group, tp.size)


def measure_train_step(
    module,
    mesh,
    rules: Sequence[Tuple[str, Tuple]],
    *,
    opt_rules: Optional[Sequence[Tuple[str, Tuple]]] = None,
    batch: int = 1,
    seq: int = 16,
    repeats: int = 3,
    device=None,
) -> float:
    """The training twin of `measure_forward_step`: wall-time one fused train
    step (loss + grad + optimizer update, `train_step.FusedTrainStep`) of a
    copy of `module` placed by ``rules`` and its optimizer state by
    ``opt_rules`` on `mesh` (a `DeviceMesh` over the process group, or None
    at one process), as `Accelerator.prepare` places them.

    A forward measurement can't rank training plans — a rule table that wins on
    decode may lose on the grad all-reduce it forces, and ZeRO moment sharding
    (``opt_rules``) never shows up in a forward pass at all. The port's
    `torch.optim.AdamW` (lr 1e-3, no weight decay) stands in for optax's
    ``adam(1e-3)`` of JAX's twin; the loss is the module's bundled loss on a
    ``[batch, seq]`` batch of zeros. Returns best-of-``repeats`` seconds after
    a first step outside the timer, the slowest process's of the mesh."""
    import copy
    import time

    from ..device import resolve_device
    from ..modeling import Model, PreparedModel
    from ..optimizer import AcceleratedOptimizer
    from ..train_step import FusedTrainStep

    device = resolve_device(device)
    bundle = Model(copy.deepcopy(module), loss_fn=getattr(module, "loss_fn", None), sharding_rules=list(rules),
                   opt_sharding_rules=list(opt_rules) if opt_rules else None)
    pmodel = PreparedModel(bundle, device, mesh=mesh)
    optimizer = torch.optim.AdamW(pmodel.module.parameters(), lr=1e-3, weight_decay=0.0)
    step = FusedTrainStep(pmodel, AcceleratedOptimizer(optimizer, model=pmodel))
    batch_ = {"input_ids": torch.zeros((batch, seq), dtype=torch.long, device=device)}
    step(batch_)
    _synchronize(device)
    best = float("inf")
    for _ in range(max(1, repeats)):
        start = time.perf_counter()
        step(batch_)
        _synchronize(device)
        best = min(best, time.perf_counter() - start)
    del step, optimizer, pmodel, bundle
    return best if mesh is None else _slowest(best, device, None, mesh.size())


def refine_plans(
    plans: Sequence[ShardingPlan],
    measure_fn: Callable[[ShardingPlan], float],
    *,
    repeats: int = 1,
) -> Tuple[ShardingPlan, List[Tuple[ShardingPlan, float]]]:
    """Measure-and-refine: the cost model proposes (`top_k` candidates from
    `plan_sharding`), the hardware disposes. ``measure_fn(plan) -> seconds``
    compiles and times one candidate (see `measure_forward_step`); the
    measured-best plan is returned with ``measured_step_s`` stamped, plus the
    full (plan, seconds) list for reporting."""
    if not plans:
        raise ValueError("refine_plans needs at least one candidate plan")
    measured: List[Tuple[ShardingPlan, float]] = []
    for plan in plans:
        seconds = min(measure_fn(plan) for _ in range(max(1, repeats)))
        plan.measured_step_s = seconds
        measured.append((plan, seconds))
    best = min(measured, key=lambda pair: pair[1])[0]
    return best, measured


# ------------------------------------------------------------------ the seam
def resolve_sharding_rules(
    sharding_rules,
    params,
    mesh,
    *,
    plan_kwargs: Optional[Dict[str, Any]] = None,
):
    """The sentinel seam every consumer shares — `Accelerator.prepare_model`
    and `ContinuousBatcher` accept the same value set: a list/tuple passes
    through, ``None`` / ``"rules"`` stay ``None`` (caller falls back to the
    model family table), and ``"auto"`` runs the planner. Returns
    (rules, plan-or-None)."""
    if sharding_rules is None or sharding_rules == "rules":
        return None, None
    if isinstance(sharding_rules, (list, tuple)):
        return list(sharding_rules), None
    if sharding_rules == "auto":
        plan = plan_sharding(params, mesh, **(plan_kwargs or {}))
        return plan.rules, plan
    raise ValueError(
        f"sharding_rules must be a rules list, None, 'rules' or 'auto'; got "
        f"{sharding_rules!r}"
    )
