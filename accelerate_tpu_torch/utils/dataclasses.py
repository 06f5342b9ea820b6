"""Configuration types of the port's `Accelerator` (the part of
`accelerate_tpu/utils/dataclasses.py` its arguments need)."""

from __future__ import annotations

import copy
import enum
import os
from dataclasses import asdict, dataclass
from datetime import timedelta
from typing import Any, Optional

import torch

from .constants import FSDP_AUTO_WRAP_POLICY, FSDP_SHARDING_STRATEGY, FSDP_STATE_DICT_TYPE, MESH_AXIS_NAMES


def str_to_bool(value: str) -> int:
    """An environment variable's truth value as 1 or 0; raises on others."""
    value = value.lower()
    if value in ("y", "yes", "t", "true", "on", "1"):
        return 1
    if value in ("n", "no", "f", "false", "off", "0"):
        return 0
    raise ValueError(f"invalid truth value {value}")


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    return bool(str_to_bool(os.environ.get(key, str(default))))


class DistributedType(str, enum.Enum):
    """The JAX package's topology values. The port runs one process
    (``NO``) or several over `torch.distributed` (``MULTI_HOST``, one
    process per card); ``XLA_SPMD``, one process driving several devices,
    has no counterpart here and is kept for the values' sake."""

    NO = "NO"
    XLA_SPMD = "XLA_SPMD"
    MULTI_HOST = "MULTI_HOST"

    def __str__(self):
        return self.value


class PrecisionType(str, enum.Enum):
    """The JAX package's precision modes, all of which the port runs: ``no``,
    ``bf16``, ``fp16`` (with dynamic loss scaling) and ``fp8`` (bf16 compute,
    every linear layer's product in fp8 under `FP8RecipeKwargs`)."""

    NO = "no"
    FP8 = "fp8"
    FP16 = "fp16"
    BF16 = "bf16"

    @classmethod
    def list(cls):
        return [m.value for m in cls]


#: Compute dtype of each mode (fp8's linear products aside, bf16 under fp8).
COMPUTE_DTYPES = {"no": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16, "fp8": torch.bfloat16}


class CustomDtype(enum.Enum):
    """Sub-byte and non-native dtypes for the planner's size accounting
    (JAX's `CustomDtype`)."""

    FP8 = "fp8"
    INT4 = "int4"
    INT8 = "int8"


@dataclass
class GradientAccumulationPlugin:
    """Gradient accumulation settings: the two of the JAX package's fields
    that one process reads."""

    num_steps: int = 1
    sync_with_dataloader: bool = True

    def to_kwargs(self) -> dict:
        return asdict(self)


class KwargsHandler:
    """Base of the handlers passed as `Accelerator(kwargs_handlers=[...])`:
    `to_kwargs` gives the fields that differ from the defaults."""

    def to_dict(self):
        return copy.deepcopy(self.__dict__)

    def to_kwargs(self):
        default_dict = self.__class__().to_dict()
        this_dict = self.to_dict()
        return {k: v for k, v in this_dict.items() if default_dict[k] != v}


@dataclass
class AutocastKwargs(KwargsHandler):
    """The compute-dtype policy of the prepared models' forwards (JAX's
    `AutocastKwargs`). ``enabled=False`` runs a model in its parameters'
    dtype, without the casts of its mixed-precision mode, for the whole run
    (`Accelerator(kwargs_handlers=[...])`) or inside `Accelerator.autocast`.
    `cache_enabled` is accepted for parity and read by nothing."""

    enabled: bool = True
    cache_enabled: Optional[bool] = None


@dataclass
class InitProcessGroupKwargs(KwargsHandler):
    """What `torch.distributed.init_process_group` gets when the
    `PartialState` builds the process group (JAX's fields). `timeout` is the
    group's collective timeout, 1800 s by default as in JAX; `backend`
    None takes the port's choice (NCCL on the card, gloo on the CPU);
    `init_method` None takes the launcher's variables (``env://``)."""

    backend: Optional[str] = None
    init_method: Optional[str] = None
    timeout: Optional[timedelta] = None

    def __post_init__(self):
        if self.timeout is None:
            self.timeout = timedelta(seconds=1800)


@dataclass
class DistributedDataParallelKwargs(KwargsHandler):
    """Accepted for parity with JAX's DDP kwargs, which accepts them from the
    reference's scripts and reads none. The port's data parallel is
    `parallel/fsdp.py`'s flat all-reduce of the gradients once a step, not
    torch's `DistributedDataParallel`: there are no buckets to size, no
    unused parameters to find and no graph to keep static, so no field here
    changes anything."""

    dim: int = 0
    broadcast_buffers: bool = True
    bucket_cap_mb: int = 25
    find_unused_parameters: bool = False
    check_reduction: bool = False
    gradient_as_bucket_view: bool = False
    static_graph: bool = False


class RNGType(str, enum.Enum):
    """The generators that `utils.random.synchronize_rng_states` brings into
    agreement across processes: Python's, numpy's, a loader's sampler
    (``generator``) and torch's default generator. JAX's list has ``jax``
    in the last place, a no-op there because its keys agree across
    processes by construction; a torch generator holds state in each
    process, so its counterpart, ``torch``, broadcasts process 0's state."""

    PYTHON = "python"
    NUMPY = "numpy"
    TORCH = "torch"
    GENERATOR = "generator"

    def __str__(self):
        return self.value


@dataclass
class GradScalerKwargs(KwargsHandler):
    """Dynamic loss scaling for ``mixed_precision="fp16"``, with the JAX
    package's defaults; passed to `Accelerator(kwargs_handlers=[...])`."""

    init_scale: float = 65536.0
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


@dataclass
class FP8RecipeKwargs(KwargsHandler):
    """The fp8 recipe of ``mixed_precision="fp8"``, with the JAX package's
    fields, defaults and checks; passed to `Accelerator(kwargs_handlers=[...])`.
    `fp8_format` "HYBRID" takes the backward's gradients in e5m2, "E4M3"
    everything in e4m3; `scaling` "dynamic" scales each tensor by its own
    amax, "delayed" by a rolling window of `amax_history_len` amaxes
    (`ops/fp8.py`). `margin`, `interval` and `override_linear_precision` are
    accepted and, as in the JAX package, read by nothing."""

    margin: int = 0
    interval: int = 1
    fp8_format: str = "HYBRID"  # E4M3 | HYBRID
    scaling: str = "dynamic"  # dynamic | delayed
    amax_history_len: int = 1024
    amax_compute_algo: str = "most_recent"
    override_linear_precision: tuple = (False, False, False)

    def __post_init__(self):
        self.fp8_format = self.fp8_format.upper()
        if self.fp8_format not in ("E4M3", "HYBRID"):
            raise ValueError("fp8_format must be E4M3 or HYBRID")
        self.scaling = self.scaling.lower()
        if self.scaling not in ("dynamic", "delayed"):
            raise ValueError("scaling must be dynamic or delayed")
        if self.amax_compute_algo not in ("max", "most_recent"):
            raise ValueError("amax_compute_algo must be max or most_recent")


@dataclass
class ProjectConfiguration:
    """Where `Accelerator.save_state` writes: with
    `automatic_checkpoint_naming`, ``{project_dir}/checkpoints/checkpoint_{iteration}``
    through `checkpointing.CheckpointManager`, keeping the last `total_limit`.
    Trackers write under `logging_dir`, `project_dir` unless set."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0

    def set_directories(self, project_dir=None):
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        self.set_directories(self.project_dir)


@dataclass
class DataLoaderConfiguration:
    """How `Accelerator.prepare` wraps a loader, with JAX's fields and
    defaults. `dispatch_batches`: process 0 reads each global batch and
    sends every process its rows (`data_loader.DataLoaderDispatcher`; None
    means so for an iterable dataset across processes). `split_batches`:
    the loader's batch is the global batch, cut across the processes.
    `even_batches`: the last global batch is topped up so every process
    gets a full one (`gather_for_metrics` cuts the repeats).
    `use_seedable_sampler`: a torch loader's `RandomSampler` becomes a
    `SeedableRandomSampler`. `non_blocking`, `prefetch_size` and
    `drop_last` are accepted for parity: the port moves each batch when it
    is taken, with no prefetch thread."""

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = True
    non_blocking: bool = True
    prefetch_size: int = 2
    drop_last: Optional[bool] = None


@dataclass
class CompilationConfig:
    """The JAX package's compilation options, of which one has a meaning
    here: `remat_policy` (None or one of `ops.remat.POLICY_NAMES`), the
    activation checkpointing of every in-tree layer. Its XLA-only fields
    (`donate_params`, `scan_layers`, `cache_dir`, `xla_flags`) have no
    counterpart in eager PyTorch and are left out."""

    remat_policy: Optional[str] = None


@dataclass
class ParallelismConfig:
    """Mesh shape: one size per axis of `constants.MESH_AXIS_NAMES`, with
    JAX's fields, defaults and checks. -1 absorbs the devices left over (at
    most one axis; by default "data"). `resolve(world)` gives the concrete
    sizes; the port's mesh (`parallel.mesh.build_mesh`) takes "data",
    "fsdp" and "model" ("model" not with "fsdp") and refuses any other axis
    above 1."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    expert: int = 1
    stage: int = 1
    pipeline: int = 1

    def __post_init__(self):
        sizes = self.axis_sizes()
        if sum(1 for v in sizes.values() if v == -1) > 1:
            raise ValueError(f"At most one mesh axis may be -1 (auto), got {sizes}")

    def axis_sizes(self) -> dict:
        return {name: getattr(self, name) for name in MESH_AXIS_NAMES}

    def resolve(self, num_devices: int) -> dict:
        """Every axis's size for `num_devices`, the -1 axis filled in; the
        sizes must multiply to `num_devices`."""
        sizes = self.axis_sizes()
        fixed = 1
        auto_axis = None
        for name, v in sizes.items():
            if v == -1:
                auto_axis = name
            else:
                if v < 1:
                    raise ValueError(f"Axis {name} must be >=1 or -1, got {v}")
                fixed *= v
        if auto_axis is None:
            if fixed != num_devices:
                raise ValueError(f"Mesh of {fixed} devices does not match {num_devices} available devices")
            return sizes
        if num_devices % fixed != 0:
            raise ValueError(f"Fixed axes use {fixed} devices which does not divide {num_devices}")
        sizes[auto_axis] = num_devices // fixed
        return sizes

    @classmethod
    def from_env(cls) -> "ParallelismConfig":
        kw = {}
        for name in MESH_AXIS_NAMES:
            env = os.environ.get(f"ACCELERATE_TPU_MESH_{name.upper()}")
            if env is not None:
                kw[name] = int(env)
        return cls(**kw)


@dataclass
class FullyShardedDataParallelPlugin:
    """FSDP/ZeRO with the JAX package's fields, defaults and environment
    protocol (``ACCELERATE_TPU_FSDP_*``). The strategy picks what shards
    over the mesh's "fsdp" axis (`parallel.sharding`):

      - FULL_SHARD (ZeRO-3): parameters, gradients and optimizer state;
      - SHARD_GRAD_OP (ZeRO-2): gradients and optimizer state, the
        parameters replicated;
      - NO_SHARD: nothing (data parallel);
      - HYBRID_SHARD: as FULL_SHARD over "fsdp", replicated over "data";
        HYBRID_SHARD_ZERO2 as SHARD_GRAD_OP over "fsdp".

    `auto_wrap_policy`, `min_num_params` and `transformer_cls_names_to_wrap`
    decide which parameters join the shard group, as in JAX.
    `param_dtype` is the parameters' storage dtype (and so the gradients'
    wire dtype), `reduce_dtype` that of gradient accumulation across
    microbatches. `activation_checkpointing` checkpoints every in-tree layer
    (``remat_policy="full"``); `sync_module_states` broadcasts rank 0's
    weights at `prepare`. `state_dict_type` is kept, and the port writes
    the full state either way (a sharded save raises at the `Accelerator`).

    The offload tiers, as JAX's: `offload_optimizer_state` keeps the
    optimizer's state in pinned host memory and streams it through the card
    a parameter group at a time for the update; `offload_params` keeps the
    f32 masters there between steps; both follow `cpu_offload` (env
    ``ACCELERATE_TPU_FSDP_OFFLOAD_PARAMS``) when None.
    ``offload_optimizer_device="disk"`` (or "nvme") keeps the state in the
    disk store under `offload_dir` (a temporary directory by default);
    "cpu" and "pinned_host" are the host tier.
    """

    sharding_strategy: str = "FULL_SHARD"
    auto_wrap_policy: Optional[str] = None
    min_num_params: int = 0
    transformer_cls_names_to_wrap: Optional[list] = None
    cpu_offload: bool = False
    offload_optimizer_state: Optional[bool] = None
    offload_params: Optional[bool] = None
    offload_optimizer_device: Optional[str] = None
    offload_dir: Optional[str] = None
    state_dict_type: str = "SHARDED_STATE_DICT"
    activation_checkpointing: bool = False
    sync_module_states: bool = True
    param_dtype: Optional[str] = None
    reduce_dtype: Optional[str] = None
    use_orig_params: bool = True

    def __post_init__(self):
        prefix = "ACCELERATE_TPU_FSDP_"
        env = os.environ
        if isinstance(self.sharding_strategy, int):
            self.sharding_strategy = FSDP_SHARDING_STRATEGY[self.sharding_strategy - 1]
        self.sharding_strategy = env.get(prefix + "SHARDING_STRATEGY", self.sharding_strategy)
        if self.sharding_strategy not in FSDP_SHARDING_STRATEGY:
            raise ValueError(
                f"sharding_strategy must be one of {FSDP_SHARDING_STRATEGY}, got {self.sharding_strategy}"
            )
        self.auto_wrap_policy = env.get(prefix + "AUTO_WRAP_POLICY", self.auto_wrap_policy)
        if self.auto_wrap_policy is not None and self.auto_wrap_policy not in FSDP_AUTO_WRAP_POLICY:
            raise ValueError(f"auto_wrap_policy must be one of {FSDP_AUTO_WRAP_POLICY}")
        if prefix + "TRANSFORMER_CLS_TO_WRAP" in env:
            self.transformer_cls_names_to_wrap = [
                s.strip() for s in env[prefix + "TRANSFORMER_CLS_TO_WRAP"].split(",") if s.strip()
            ]
        if self.auto_wrap_policy == "TRANSFORMER_BASED_WRAP" and not self.transformer_cls_names_to_wrap:
            raise ValueError(
                "auto_wrap_policy='TRANSFORMER_BASED_WRAP' requires transformer_cls_names_to_wrap "
                "(the layer-class/param-path names whose parameters shard over the fsdp axis)"
            )
        self.min_num_params = int(env.get(prefix + "MIN_NUM_PARAMS", self.min_num_params))
        self.param_dtype = env.get(prefix + "PARAM_DTYPE", self.param_dtype)
        self.reduce_dtype = env.get(prefix + "REDUCE_DTYPE", self.reduce_dtype)
        for fld in ("param_dtype", "reduce_dtype"):
            val = getattr(self, fld)
            if val is not None and val not in ("float32", "bfloat16", "float16"):
                raise ValueError(f"{fld} must be float32|bfloat16|float16, got {val!r}")
        self.sync_module_states = parse_flag_from_env(prefix + "SYNC_MODULE_STATES", self.sync_module_states)
        self.cpu_offload = parse_flag_from_env(prefix + "OFFLOAD_PARAMS", self.cpu_offload)
        if self.offload_optimizer_state is None:
            self.offload_optimizer_state = self.cpu_offload
        if self.offload_params is None:
            self.offload_params = self.cpu_offload
        self.offload_optimizer_device = env.get(prefix + "OFFLOAD_OPTIMIZER_DEVICE", self.offload_optimizer_device)
        if self.offload_optimizer_device is not None and self.offload_optimizer_device.lower() not in (
                "disk", "nvme", "cpu", "pinned_host"):
            raise ValueError(
                f"offload_optimizer_device must be disk|nvme|cpu|pinned_host, got {self.offload_optimizer_device!r}"
            )
        if self.offload_optimizer_device is not None and self.offload_optimizer_device.lower() in ("cpu", "pinned_host"):
            # The host tier is the boolean knob's behavior; normalize.
            self.offload_optimizer_state = True
            self.offload_optimizer_device = None
        self.offload_dir = env.get(prefix + "OFFLOAD_DIR", self.offload_dir)
        self.state_dict_type = env.get(prefix + "STATE_DICT_TYPE", self.state_dict_type)
        if self.state_dict_type not in FSDP_STATE_DICT_TYPE:
            raise ValueError(f"state_dict_type must be one of {FSDP_STATE_DICT_TYPE}")
        self.activation_checkpointing = parse_flag_from_env(
            prefix + "ACTIVATION_CHECKPOINTING", self.activation_checkpointing
        )

    @property
    def shards_params(self) -> bool:
        return self.sharding_strategy in ("FULL_SHARD", "HYBRID_SHARD")

    @property
    def shards_opt_state(self) -> bool:
        return self.sharding_strategy != "NO_SHARD"

    @property
    def offload_to_disk(self) -> bool:
        """The optimizer's state lives in the disk store."""
        return str(self.offload_optimizer_device or "").lower() in ("disk", "nvme")


@dataclass
class DeepSpeedPlugin:
    """A DeepSpeed-shaped config lowered to the FSDP plugin, as JAX's
    compatibility shim: ZeRO stage 0 is NO_SHARD, 1 and 2 SHARD_GRAD_OP
    (the optimizer's state and the gradients sharded), 3 FULL_SHARD; an
    optimizer offload to "cpu" is the pinned host tier, to "nvme" the disk
    tier; a parameter offload to either keeps the masters in host memory.
    `hf_ds_config` (a dict) overrides the fields it names;
    ``ACCELERATE_TPU_ZERO_STAGE`` and
    ``ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS`` override the arguments."""

    hf_ds_config: Any = None
    gradient_accumulation_steps: int = 1
    gradient_clipping: Optional[float] = None
    zero_stage: int = 2
    offload_optimizer_device: Optional[str] = None  # none|cpu|nvme
    offload_param_device: Optional[str] = None
    zero3_init_flag: bool = False
    zero3_save_16bit_model: bool = False
    train_micro_batch_size_per_gpu: Optional[int] = None

    def __post_init__(self):
        env = os.environ
        self.zero_stage = int(env.get("ACCELERATE_TPU_ZERO_STAGE", self.zero_stage))
        self.gradient_accumulation_steps = int(
            env.get("ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS", self.gradient_accumulation_steps)
        )
        if isinstance(self.hf_ds_config, dict):
            cfg = self.hf_ds_config
            zero = cfg.get("zero_optimization", {})
            self.zero_stage = zero.get("stage", self.zero_stage)
            if "offload_optimizer" in zero:
                self.offload_optimizer_device = zero["offload_optimizer"].get("device")
            if "offload_param" in zero:
                self.offload_param_device = zero["offload_param"].get("device")
            if "gradient_accumulation_steps" in cfg and cfg["gradient_accumulation_steps"] != "auto":
                self.gradient_accumulation_steps = cfg["gradient_accumulation_steps"]
            if "gradient_clipping" in cfg and cfg["gradient_clipping"] != "auto":
                self.gradient_clipping = cfg["gradient_clipping"]

    def to_fsdp_plugin(self) -> FullyShardedDataParallelPlugin:
        stage_map = {0: "NO_SHARD", 1: "SHARD_GRAD_OP", 2: "SHARD_GRAD_OP", 3: "FULL_SHARD"}
        if self.zero_stage not in stage_map:
            raise ValueError(
                f"zero_stage must be one of {sorted(stage_map)}, got {self.zero_stage!r} "
                "(note: 'auto' is not resolvable without a training context; set an explicit stage)"
            )
        return FullyShardedDataParallelPlugin(
            sharding_strategy=stage_map[self.zero_stage],
            cpu_offload=self.offload_param_device in ("cpu", "nvme") or self.offload_optimizer_device in ("cpu", "nvme"),
            offload_optimizer_state=self.offload_optimizer_device in ("cpu", "nvme"),
            offload_params=self.offload_param_device in ("cpu", "nvme"),
            # DeepSpeed's NVMe offload is the disk tier.
            offload_optimizer_device="disk" if self.offload_optimizer_device == "nvme" else None,
        )


@dataclass
class MegatronLMPlugin:
    """Megatron-shaped degrees lowered to a `ParallelismConfig`, as JAX's
    compatibility shim: tensor parallel to the "model" axis, pipeline to
    "stage", sequence parallel to "seq" (the tensor-parallel degree by
    default), expert parallel to "expert", data the rest. The port's mesh
    runs "model" (tensor parallel) and refuses a degree above 1 on each of
    the others, naming the ROADMAP bullet that ports it
    (`parallel.mesh.WAITING_AXES`)."""

    tp_degree: int = 1
    pp_degree: int = 1
    num_micro_batches: int = 1
    sequence_parallelism: bool = False
    sequence_parallel_degree: int = 1
    expert_parallel_degree: int = 1
    recompute_activations: bool = False

    def __post_init__(self):
        env = os.environ
        self.tp_degree = int(env.get("ACCELERATE_TPU_MEGATRON_TP_DEGREE", self.tp_degree))
        self.pp_degree = int(env.get("ACCELERATE_TPU_MEGATRON_PP_DEGREE", self.pp_degree))
        if self.sequence_parallelism and self.sequence_parallel_degree == 1:
            # Megatron's sequence parallel shards over the tensor-parallel group.
            self.sequence_parallel_degree = self.tp_degree

    def to_parallelism_config(self) -> ParallelismConfig:
        return ParallelismConfig(
            data=-1,
            model=self.tp_degree,
            stage=self.pp_degree,
            seq=self.sequence_parallel_degree if self.sequence_parallelism else 1,
            expert=self.expert_parallel_degree,
        )
