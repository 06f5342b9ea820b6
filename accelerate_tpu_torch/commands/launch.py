"""``accelerate-tpu-torch launch``: run a training script with JAX's launch
protocol (the port of `accelerate_tpu/commands/launch.py`).

The flags, the configuration keys, their merge (a flag over the file) and
the ``ACCELERATE_TPU_*`` variables are JAX's: `build_launch_env` writes the
same ones for the same flags and file, and the port's worker side reads them
back (`AcceleratorState`, `Accelerator`, `PartialState.debug`,
`ParallelismConfig.from_env`, `FullyShardedDataParallelPlugin`, the
profiler and the tracer). The topology is torch's, one process a card:

  - ``--num_processes N`` (N > 1) without ``--coordinator_address`` runs N
    local children (`launchers.LocalProcesses`), rank i with ``RANK`` and
    ``LOCAL_RANK`` i, ``WORLD_SIZE`` N, ``MASTER_ADDR`` 127.0.0.1 and a free
    ``MASTER_PORT``. On the card N may not exceed the cards there. The
    launcher waits for all; when one fails the others get
    `launchers.GRACE_S` seconds and are then terminated, and its exit code
    is the first failure's.
  - ``--coordinator_address host:port --process_id i`` makes this
    invocation process i of ``--num_processes``, JAX's contract across
    hosts: ``MASTER_ADDR``/``MASTER_PORT`` come from the address.
  - One process without a coordinator is one plain child with no group.
  - ``--cpu`` adds ``ACCELERATE_TPU_USE_CPU=1`` (gloo, the CPU) where JAX
    sets ``JAX_PLATFORMS``/``XLA_FLAGS``; without it a child that finds no
    card raises.
  - ``--max_restarts N`` wraps the child, or the whole group, in
    `fault_tolerance.Supervisor`, with the trace context carried into each
    attempt under ``--trace_dir``.

A flag or key whose worker side the port lacks is refused here, naming the
ROADMAP item that ports it (`refuse_unported`), so none is dropped without
a word.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from .config import MESH_AXES, load_config_file

_CLUSTER = "waits for ROADMAP A item 2, the GPU-host counterpart of tpu.py and cloud.py"
_FLEET = "waits for ROADMAP A item 6, the serving fleet (chaos plans, replicas)"
_SEQUENCE = "waits for ROADMAP A item 3, sequence parallel"


class UnportedLaunchOption(NotImplementedError):
    """A launch flag or configuration key the port cannot serve yet."""


def register_subcommand(subparsers):
    parser = subparsers.add_parser("launch", help="Launch a script with accelerate-tpu-torch", add_help=True)
    add_launch_args(parser)
    parser.set_defaults(func=launch_command)
    return parser


def add_cloud_args(parser):
    """JAX's cloud flags, taken so that a JAX command line parses; `--cloud`
    is refused."""
    parser.add_argument("--cloud", action="store_true", help=f"Managed-cloud launch ({_CLUSTER})")
    for name in ("cloud_name", "cloud_project", "cloud_zone", "cloud_accelerator_type", "cloud_runtime_version",
                 "cloud_output_gcs"):
        parser.add_argument(f"--{name}", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--cloud_spot", action="store_true", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--cloud_no_teardown", dest="cloud_teardown", action="store_false", default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--dry_run", action="store_true", help=argparse.SUPPRESS)
    return parser


def add_launch_args(parser):
    parser.add_argument("--config_file", default=None)
    parser.add_argument("--mixed_precision", default=None, choices=[None, "no", "bf16", "fp16", "fp8"])
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Processes, one a card (or a CPU process each under --cpu)")
    parser.add_argument("--process_id", type=int, default=None, help="This invocation's rank (with a coordinator)")
    parser.add_argument("--coordinator_address", default=None, help="host:port of process 0 (across hosts)")
    parser.add_argument("--gradient_accumulation_steps", type=int, default=None)
    parser.add_argument("--debug", action="store_true", help="Enable collective shape verification")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU over gloo (debug/testing)")
    parser.add_argument("--num_cpu_devices", type=int, default=None,
                        help="Refused: the port runs one CPU process a rank (use --cpu --num_processes N)")
    parser.add_argument("--profile_dir", default=None,
                        help="Arm on-demand profiling in every worker (telemetry.ProfilerManager)")
    parser.add_argument("--trace_dir", default=None,
                        help="Arm tracing and the flight recorder in every worker; one trace id is minted "
                        "so supervised restarts stitch into one timeline (`trace export`)")
    for axis in MESH_AXES:
        parser.add_argument(f"--mesh_{axis}", type=int, default=None, help=f"Mesh axis size for `{axis}`")
    parser.add_argument("--max_restarts", type=int, default=0, help="Restart budget on child failure (supervision)")
    parser.add_argument("--grace_period", type=float, default=None,
                        help="Seconds a signaled child gets before the kill (default 30, or the config file's)")
    parser.add_argument("--restart_backoff", type=float, default=None,
                        help="Base seconds of the linear restart backoff (default 1, or the config file's)")
    parser.add_argument("--max_backoff", type=float, default=None, help="Backoff ceiling in seconds (default 30)")
    parser.add_argument("--crash_loop_threshold", type=int, default=None,
                        help="Stop after N identical fast crashes in a row (default 3; 0 disables)")
    parser.add_argument("--fault_plan", default=None, help=f"Refused: {_FLEET}")
    parser.add_argument("--async_save", action="store_true",
                        help="Asynchronous checkpoints in every worker (ACCELERATE_TPU_ASYNC_SAVE): save_state blocks "
                             "only for the copy of the state to host memory; a background committer writes and "
                             "publishes it")
    parser.add_argument("--sharded_save", action="store_true",
                        help="Per-process sharded checkpoints (ACCELERATE_TPU_SHARDED_SAVE): each process writes "
                             "its own shards into its host_*/ subdirectory; a load gathers them")
    parser.add_argument("--replicas", type=int, default=None, help=f"Refused: {_FLEET}")
    parser.add_argument("--tpu_use_cluster", action="store_true", help=f"Refused: {_CLUSTER}")
    parser.add_argument("--tpu_name", default=None)
    parser.add_argument("--tpu_zone", default=None)
    add_cloud_args(parser)
    parser.add_argument("training_script", type=str, help="The script to launch")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER, help="Script arguments")
    return parser


def refuse_unported(args, config: dict):
    """Raise `UnportedLaunchOption` naming every flag or key given that the
    port's worker side cannot serve, each with the item that ports it."""
    from ..parallel.mesh import WAITING_AXES

    found = []
    if args.tpu_use_cluster or config.get("tpu_use_cluster"):
        found.append(f"--tpu_use_cluster / tpu_use_cluster (a launch on every host of a cluster) {_CLUSTER}")
    if args.cloud or config.get("cloud_config") or config.get("compute_environment") == "GCP_CLOUD":
        found.append(f"--cloud / cloud_config (a managed-cloud launch) {_CLUSTER}")
    if args.fault_plan or config.get("fault_plan"):
        found.append(f"--fault_plan / fault_plan (a chaos fault plan) {_FLEET}")
    if args.replicas or config.get("replicas"):
        found.append(f"--replicas / replicas (a serving fleet) {_FLEET}")
    if config.get("sequence_parallel_config"):
        found.append(f"sequence_parallel_config {_SEQUENCE}")
    mesh_cfg = config.get("mesh", {}) or {}
    for axis in ("seq", "expert", "stage"):  # "model" runs since ROADMAP A item 3's tensor parallel
        size = getattr(args, f"mesh_{axis}")
        size = mesh_cfg.get(axis) if size is None else size
        if size is not None and int(size) != 1:
            found.append(f"mesh axis {axis!r} of size {size} waits for {WAITING_AXES[axis]}")
    if config.get("compilation_cache"):
        found.append("compilation_cache has no counterpart in the port: it compiles no program per shape (its "
                     "kernels build once into build/, keyed by their sources' hash)")
    if config.get("downcast_bf16"):
        found.append("downcast_bf16 has no counterpart in the port: torch keeps a float64 tensor as the script "
                     "made it; cast it in the script")
    if args.num_cpu_devices:
        found.append("--num_cpu_devices has no meaning in the port, which runs one CPU process a rank: use --cpu "
                     "--num_processes N")
    if found:
        raise UnportedLaunchOption("accelerate-tpu-torch launch cannot serve: " + "; ".join(found))


def topology(args, config: dict):
    """(num_processes, coordinator address or None), flags over the file."""
    num_processes = int(args.num_processes if args.num_processes is not None else config.get("num_processes", 1) or 1)
    coordinator = args.coordinator_address if args.coordinator_address is not None else config.get(
        "coordinator_address")
    return num_processes, coordinator


def build_launch_env(args, config: dict) -> dict:
    """Merge the flags over the configuration into JAX's ``ACCELERATE_TPU_*``
    protocol and torch's group variables; refuses what the port cannot
    serve. The local group's per-rank variables are added at spawn
    (`launchers.rank_env`)."""
    refuse_unported(args, config)
    env = os.environ.copy()

    def pick(cli_val, key, default=None):
        if cli_val is not None:
            return cli_val
        return config.get(key, default)

    mp = pick(args.mixed_precision, "mixed_precision")
    if mp:
        env["ACCELERATE_TPU_MIXED_PRECISION"] = str(mp)
    gas = pick(args.gradient_accumulation_steps, "gradient_accumulation_steps")
    if gas:
        env["ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS"] = str(gas)
    mesh_cfg = config.get("mesh", {}) or {}
    for axis in MESH_AXES:
        val = getattr(args, f"mesh_{axis}")
        if val is None:
            val = mesh_cfg.get(axis)
        if val is not None:
            env[f"ACCELERATE_TPU_MESH_{axis.upper()}"] = str(val)
    if args.debug or config.get("debug"):
        env["ACCELERATE_TPU_DEBUG_MODE"] = "1"
    if args.async_save or config.get("async_save"):
        env["ACCELERATE_TPU_ASYNC_SAVE"] = "1"
    if args.sharded_save or config.get("sharded_save"):
        env["ACCELERATE_TPU_SHARDED_SAVE"] = "1"
    profile_dir = pick(args.profile_dir, "profile_dir")
    if profile_dir:
        env["ACCELERATE_TPU_PROFILE_DIR"] = str(profile_dir)
    trace_dir = pick(args.trace_dir, "trace_dir")
    if trace_dir:
        from ..telemetry.tracing import TRACE_DIR_ENV, TRACE_ID_ENV, new_id

        env[TRACE_DIR_ENV] = str(trace_dir)
        # One trace id for every worker and every supervised restart.
        env.setdefault(TRACE_ID_ENV, new_id())

    fsdp_cfg = config.get("fsdp_config") or {}
    if fsdp_cfg:
        env["ACCELERATE_TPU_USE_FSDP"] = "1"
        mapping = {
            "sharding_strategy": "SHARDING_STRATEGY",
            "min_num_params": "MIN_NUM_PARAMS",
            "cpu_offload": "OFFLOAD_PARAMS",
            "activation_checkpointing": "ACTIVATION_CHECKPOINTING",
            "state_dict_type": "STATE_DICT_TYPE",
            "auto_wrap_policy": "AUTO_WRAP_POLICY",
            "transformer_cls_names_to_wrap": "TRANSFORMER_CLS_TO_WRAP",
            "param_dtype": "PARAM_DTYPE",
            "reduce_dtype": "REDUCE_DTYPE",
            "sync_module_states": "SYNC_MODULE_STATES",
            "offload_optimizer_device": "OFFLOAD_OPTIMIZER_DEVICE",
            "offload_dir": "OFFLOAD_DIR",
        }
        for key, suffix in mapping.items():
            if key in fsdp_cfg and fsdp_cfg[key] is not None:
                val = fsdp_cfg[key]
                if isinstance(val, bool):
                    val = str(val).lower()
                elif isinstance(val, (list, tuple)):
                    if any("," in str(v) for v in val):
                        raise ValueError(
                            f"fsdp_config.{key} entries cannot contain ',' (the env-protocol "
                            f"separator): {val}. Use a comma-free regex (e.g. 'layer_[0-9]+')."
                        )
                    val = ",".join(str(v) for v in val)
                env[f"ACCELERATE_TPU_FSDP_{suffix}"] = str(val)

    num_processes, coordinator = topology(args, config)
    if num_processes > 1 and coordinator is not None:
        process_id = args.process_id
        if process_id is None:
            process_id = int(os.environ.get("ACCELERATE_TPU_PROCESS_ID", "0"))
        env["ACCELERATE_TPU_COORDINATOR_ADDRESS"] = str(coordinator)
        env["ACCELERATE_TPU_NUM_PROCESSES"] = str(num_processes)
        env["ACCELERATE_TPU_PROCESS_ID"] = str(process_id)
        host, _, port = str(coordinator).rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"--coordinator_address must be host:port, got {coordinator!r}")
        env.update(RANK=str(process_id), WORLD_SIZE=str(num_processes), MASTER_ADDR=host, MASTER_PORT=port,
                   LOCAL_RANK=os.environ.get("ACCELERATE_TPU_LOCAL_PROCESS_INDEX", "0"))
    if args.cpu:
        env["ACCELERATE_TPU_USE_CPU"] = "1"
    return env


def local_processes(args, config: dict) -> int:
    """How many children this invocation runs: N for a local group, else 1.
    On the card a group takes one card a rank."""
    num_processes, coordinator = topology(args, config)
    if num_processes <= 1 or coordinator is not None:
        return 1
    if not args.cpu:
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if num_processes > cards:
            raise ValueError(f"--num_processes {num_processes} needs one card a process and this host has {cards} "
                             "(NCCL takes one rank per device); pass --cpu for gloo processes on the CPU")
    return num_processes


def launch_command(args):
    config = load_config_file(args.config_file)
    try:
        env = build_launch_env(args, config)
        children = local_processes(args, config)
    except (UnportedLaunchOption, ValueError) as e:
        print(f"accelerate-tpu-torch launch: {e}", file=sys.stderr)
        raise SystemExit(2) from e
    cmd = [sys.executable, args.training_script] + list(args.training_script_args)
    max_restarts = args.max_restarts or int(config.get("max_restarts", 0) or 0)
    if max_restarts > 0 or children > 1:
        from ..fault_tolerance import Supervisor

        grace = args.grace_period if args.grace_period is not None else float(config.get("grace_period", 30.0))
        backoff = args.restart_backoff if args.restart_backoff is not None else float(config.get("restart_backoff", 1.0))
        max_backoff = args.max_backoff if args.max_backoff is not None else float(config.get("max_backoff", 30.0))
        crash_loop = (args.crash_loop_threshold if args.crash_loop_threshold is not None
                      else int(config.get("crash_loop_threshold", 3)))
        tracer = None
        if max_restarts > 0 and env.get("ACCELERATE_TPU_TRACE_DIR"):
            # Attempt spans, and each attempt's parent id injected into its child.
            from ..telemetry.flight_recorder import FlightRecorder
            from ..telemetry.tracing import Tracer

            tracer = Tracer(recorder=FlightRecorder(log_dir=env["ACCELERATE_TPU_TRACE_DIR"]),
                            trace_id=env.get("ACCELERATE_TPU_TRACE_ID"), category="supervisor")
        code = Supervisor(cmd, env=env, max_restarts=max_restarts, grace_period=grace, backoff_seconds=backoff,
                          max_backoff_seconds=max_backoff, crash_loop_threshold=crash_loop, tracer=tracer,
                          num_processes=children).run()
        if code != 0:
            raise SystemExit(code)
        return
    process = subprocess.run(cmd, env=env)
    if process.returncode != 0:
        raise SystemExit(process.returncode)


def main():
    parser = argparse.ArgumentParser("accelerate-tpu-torch-launch", allow_abbrev=False)
    add_launch_args(parser)
    args = parser.parse_args()
    launch_command(args)


if __name__ == "__main__":
    main()
