"""The port's launcher (`accelerate_tpu_torch/commands/launch.py`,
`launchers.py`) held to JAX's launch protocol on the CPU. About 25 s, most
of it three launches of 2 gloo processes.

  - The worker side: under JAX's launch variables
    (``ACCELERATE_TPU_MIXED_PRECISION``,
    ``ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS``,
    ``ACCELERATE_TPU_DEBUG_MODE``) the port's `Accelerator()` reads JAX's
    `mixed_precision`, `gradient_accumulation_steps` and `debug`. Exact: a
    string, an integer and a flag.
  - `build_launch_env` against JAX's for the same flags and configuration
    files: the ``ACCELERATE_TPU_*`` variables are equal, and only the
    platform's differ (``ACCELERATE_TPU_USE_CPU`` in the port;
    ``JAX_PLATFORMS``/``XLA_FLAGS`` in JAX), with torch's group variables
    beside JAX's coordinator ones.
  - Every flag and key the port cannot serve is refused, naming its item;
    ``--async_save``/``--sharded_save`` and their keys export JAX's
    variables, which each launched worker's `Accelerator()` reads.
  - ``launch --cpu --num_processes 2`` of a script: both ranks report world 2
    over gloo, the configuration from the file and the flags, and in debug
    mode a gather whose shapes part raises `DistributedOperationException`
    on both ranks, with JAX's message. Two ``--coordinator_address``
    invocations meet as one group. A failing rank ends the group with its
    exit code.
  - `notebook_launcher`: JAX's guard, precision check and variable; the
    CPU path and the card path's refusal of more processes than cards.
"""

import argparse
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from accelerate_tpu.commands import config as jax_config
from accelerate_tpu.commands import launch as jax_launch
from accelerate_tpu_torch import launchers
from accelerate_tpu_torch.commands import config as port_config
from accelerate_tpu_torch.commands import launch as port_launch
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_VARS = {"ACCELERATE_TPU_MIXED_PRECISION": "bf16", "ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS": "2",
               "ACCELERATE_TPU_DEBUG_MODE": "1"}


def _reset_port():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


@pytest.fixture(autouse=True)
def clean_port_state(monkeypatch):
    for key in (*LAUNCH_VARS, "ACCELERATE_TPU_USE_CPU", "ACCELERATE_TPU_TRACE_ID", "ACCELERATE_TPU_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    _reset_port()
    yield
    _reset_port()


def _cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    for key in LAUNCH_VARS:
        env.pop(key, None)
    return env


# ------------------------------------------------------------------ item 0: the worker side
def test_accelerator_under_jax_launch_variables_equals_jax(monkeypatch):
    """`Accelerator()` with no arguments under JAX's launch variables: the
    port's mixed precision, accumulation steps and debug flag equal JAX's
    (the parent tree gave "no", 1 and no `debug`)."""
    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu.state import PartialState as JaxPartialState
    from accelerate_tpu_torch import Accelerator

    for key, value in LAUNCH_VARS.items():
        monkeypatch.setenv(key, value)
    jax_acc = JaxAccelerator()
    port_acc = Accelerator(cpu=True)
    got = (port_acc.mixed_precision, port_acc.gradient_accumulation_steps, PartialState().debug)
    want = (jax_acc.mixed_precision, jax_acc.gradient_accumulation_steps, JaxPartialState().debug)
    assert want == ("bf16", 2, True)
    assert got == want
    # The launcher's variable wins over the argument in both.
    _reset_port()
    assert Accelerator(cpu=True, gradient_accumulation_steps=4).gradient_accumulation_steps == 2


def test_accelerator_state_takes_the_variable_only_without_an_argument(monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_MIXED_PRECISION", "fp16")
    assert AcceleratorState(cpu=True).mixed_precision == "fp16"
    _reset_port()
    assert AcceleratorState(mixed_precision="bf16", cpu=True).mixed_precision == "bf16"
    _reset_port()
    monkeypatch.delenv("ACCELERATE_TPU_MIXED_PRECISION")
    assert AcceleratorState(cpu=True).mixed_precision == "no"
    assert PartialState().debug is False


# ------------------------------------------------------------------ build_launch_env against JAX's
def _args(module, argv):
    parser = argparse.ArgumentParser(allow_abbrev=False)
    module.add_launch_args(parser)
    return parser.parse_args([*argv, "train.py"])


def _protocol(env):
    return {k: v for k, v in env.items() if k.startswith("ACCELERATE_TPU_")}


CONFIGS = {
    "none": None,
    "default": {},
    "questionnaire": dict(mesh={"data": -1, "fsdp": 2, "model": 1, "seq": 1, "expert": 1, "stage": 1},
                          gradient_accumulation_steps=4, debug=True,
                          fsdp_config={"sharding_strategy": "SHARD_GRAD_OP", "min_num_params": 2048,
                                       "cpu_offload": False, "activation_checkpointing": True,
                                       "state_dict_type": "FULL_STATE_DICT",
                                       "transformer_cls_names_to_wrap": ["LlamaDecoderLayer", "layer_[0-9]+"]}),
    "dirs": dict(mixed_precision="fp16", profile_dir="/tmp/prof", trace_dir="/tmp/trace"),
    "checkpoints": dict(async_save=True, sharded_save=True),
}
FLAGS = {
    "bare": [],
    "precision": ["--mixed_precision", "no", "--gradient_accumulation_steps", "8", "--debug"],
    "mesh": ["--mesh_data", "2", "--mesh_fsdp", "1", "--trace_dir", "/tmp/t2", "--profile_dir", "/tmp/p2"],
    "coordinator": ["--num_processes", "2", "--coordinator_address", "10.0.0.2:8476", "--process_id", "1"],
    "cpu": ["--cpu", "--mixed_precision", "bf16"],
    "checkpoints": ["--async_save", "--sharded_save"],
}


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("config_name", sorted(CONFIGS))
def test_build_launch_env_writes_jaxs_variables(tmp_path, monkeypatch, flags, config_name):
    """For the same flags and a file JAX's `write_basic_config` wrote (read
    by each package's own reader), the ``ACCELERATE_TPU_*`` variables equal
    JAX's; only the platform's differ: the port's ``ACCELERATE_TPU_USE_CPU``
    under ``--cpu``, JAX's ``JAX_PLATFORMS``/``XLA_FLAGS``; with a
    coordinator the port adds torch's group variables."""
    monkeypatch.setenv("ACCELERATE_TPU_TRACE_ID", "fixed-trace-id")  # JAX mints one otherwise
    overrides = CONFIGS[config_name]
    path = None
    if overrides is not None:
        path = jax_config.write_basic_config(str(tmp_path / "config.yaml"), **overrides)
    argv = FLAGS[flags]
    jax_env = jax_launch.build_launch_env(_args(jax_launch, argv), jax_config.load_config_file(path) if path else {})
    port_env = port_launch.build_launch_env(_args(port_launch, argv),
                                            port_config.load_config_file(path) if path else {})
    jax_vars, port_vars = _protocol(jax_env), _protocol(port_env)
    if "--cpu" in argv:
        assert port_vars.pop("ACCELERATE_TPU_USE_CPU") == "1"
        assert jax_env["JAX_PLATFORMS"] == "cpu" and "device_count=8" in jax_env["XLA_FLAGS"]
        assert port_env.get("XLA_FLAGS") == os.environ.get("XLA_FLAGS")
    assert port_vars == jax_vars
    if flags == "coordinator":
        assert (port_env["RANK"], port_env["WORLD_SIZE"], port_env["MASTER_ADDR"], port_env["MASTER_PORT"]) == (
            "1", "2", "10.0.0.2", "8476")
    else:
        assert "RANK" not in port_env or port_env["RANK"] == os.environ.get("RANK")


def test_jax_refuses_a_local_group_the_port_spawns():
    """JAX needs a coordinator for ``--num_processes 2``; the port spawns a
    local group instead (one child a rank), and on the card only as many as
    there are cards."""
    with pytest.raises(ValueError, match="coordinator_address"):
        jax_launch.build_launch_env(_args(jax_launch, ["--num_processes", "2"]), {})
    args = _args(port_launch, ["--num_processes", "2", "--cpu"])
    port_launch.build_launch_env(args, {})
    assert port_launch.local_processes(args, {}) == 2
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="one card a process"):
            port_launch.local_processes(_args(port_launch, ["--num_processes", "2"]), {})


REFUSED = {
    "tpu_use_cluster_flag": (["--tpu_use_cluster"], {}, "item 2, the GPU-host"),
    "tpu_use_cluster_key": ([], {"tpu_use_cluster": True}, "item 2, the GPU-host"),
    "cloud_flag": (["--cloud"], {}, "item 2, the GPU-host"),
    "cloud_config": ([], {"cloud_config": {"name": "job"}}, "item 2, the GPU-host"),
    "fault_plan": (["--fault_plan", "plan.json"], {}, "item 6"),
    "replicas": (["--replicas", "2"], {}, "item 6"),
    "replicas_key": ([], {"replicas": 2}, "item 6"),
    "sequence_parallel": ([], {"sequence_parallel_config": {"mode": "ring", "block_size": 256}}, "item 3, sequence"),
    "mesh_seq_key": ([], {"mesh": {"data": -1, "seq": 2}}, "item 3, sequence"),
    "mesh_expert_key": ([], {"mesh": {"data": -1, "expert": 4}}, "item 3, expert"),
    "mesh_stage_flag": (["--mesh_stage", "2"], {}, "item 3, pipelines"),
    "compilation_cache": ([], {"compilation_cache": "/tmp/xla-cache"}, "no counterpart"),
    "downcast_bf16": ([], {"downcast_bf16": True}, "no counterpart"),
    "num_cpu_devices": (["--num_cpu_devices", "8"], {}, "--num_processes"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_flags_and_keys_are_refused(case):
    """Each flag or key whose worker side the port lacks raises at launch,
    naming the ROADMAP item that ports it; JAX's defaults (every mesh axis 1,
    tpu_use_cluster and downcast_bf16 false) pass."""
    argv, config, item = REFUSED[case]
    with pytest.raises(port_launch.UnportedLaunchOption, match=item):
        port_launch.build_launch_env(_args(port_launch, argv), config)
    port_launch.build_launch_env(_args(port_launch, []), dict(jax_config.DEFAULT_CONFIG))


def test_mesh_model_flag_reaches_the_worker():
    """``--mesh_model 2`` was refused until ROADMAP A item 3's tensor
    parallel; it now reaches the workers as JAX's variable, whose
    `ParallelismConfig.from_env` reads it (a launched world of 2 trains
    over it in `tests/test_torch_tp_training.py`)."""
    env = port_launch.build_launch_env(_args(port_launch, ["--mesh_model", "2"]), {})
    jax_env = jax_launch.build_launch_env(_args(jax_launch, ["--mesh_model", "2"]), {})
    assert env["ACCELERATE_TPU_MESH_MODEL"] == jax_env["ACCELERATE_TPU_MESH_MODEL"] == "2"


def test_cli_refusal_exits_2_with_the_reason(tmp_path):
    result = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch",
                             "--tpu_use_cluster", "--cpu", str(tmp_path / "never.py")],
                            capture_output=True, text=True, timeout=120, env=_cli_env())
    assert result.returncode == 2 and "item 2" in result.stderr, result.stderr


# ------------------------------------------------------------------ launched groups
WORKER = textwrap.dedent('''
    import json, os, sys
    import torch
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.utils import operations as ops

    out_dir, fail_rank = sys.argv[1], int(sys.argv[2])
    acc = Accelerator()
    state = acc.state._partial
    report = dict(rank=acc.process_index, world=acc.num_processes, backend=state.backend,
                  device=str(acc.device), mixed_precision=acc.mixed_precision,
                  gradient_accumulation_steps=acc.gradient_accumulation_steps, debug=state.debug,
                  local_rank=state.local_process_index, async_save=acc.async_save, sharded_save=acc.sharded_save)
    if acc.process_index == fail_rank:
        sys.exit(3)
    if state.debug:
        try:
            ops.gather(torch.ones(2 + acc.process_index, 3))
            report["debug_error"] = None
        except ops.DistributedOperationException as e:
            report["debug_error"] = str(e)
    report["gathered"] = ops.gather(torch.tensor([float(acc.process_index)])).tolist()
    with open(os.path.join(out_dir, f"rank{acc.process_index}.json"), "w") as f:
        json.dump(report, f)
''')


def _launch(tmp_path, argv, fail_rank=-1, timeout=120):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch", *argv, str(script),
           str(out), str(fail_rank)]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=_cli_env()), out


def _free_port():
    """A port on 127.0.0.1 that nothing listens on right now, for an address
    the user names on every invocation (``--coordinator_address``)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reports(out, world):
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def test_launch_cpu_group_carries_the_configuration_and_debug_mode(tmp_path, monkeypatch):
    """``launch --config_file F --cpu --num_processes 2 --gradient_accumulation_steps 2
    --debug`` of a script calling `Accelerator()`: both ranks run over gloo
    at world 2 on the CPU, read bf16 from the file and 2 from the flag, and
    a gather of a tensor one row longer on rank 1 raises
    `DistributedOperationException` on both, with JAX's message."""
    from accelerate_tpu.state import PartialState as JaxPartialState
    from accelerate_tpu.utils import operations as jax_ops

    config = port_config.write_basic_config(str(tmp_path / "config.yaml"))  # bf16
    result, out = _launch(tmp_path, ["--config_file", config, "--cpu", "--num_processes", "2",
                                     "--gradient_accumulation_steps", "2", "--debug"])
    assert result.returncode == 0, result.stdout + result.stderr
    reports = _reports(out, 2)
    for rank, report in enumerate(reports):
        assert report["rank"] == rank and report["local_rank"] == rank
        assert (report["world"], report["backend"], report["device"]) == (2, "gloo", "cpu")
        assert (report["mixed_precision"], report["gradient_accumulation_steps"], report["debug"]) == ("bf16", 2, True)
        assert report["gathered"] == [0.0, 1.0]
    # JAX's message for the same two shapes (its gather of the shapes patched
    # to return both processes'), with the port's module path.
    shapes = [{"shape": (2 + r, 3), "dtype": "float32"} for r in range(2)]
    monkeypatch.setenv("ACCELERATE_TPU_DEBUG_MODE", "1")
    JaxPartialState()
    monkeypatch.setitem(JaxPartialState._shared_state, "num_processes", 2)
    monkeypatch.setattr(jax_ops, "gather_object", lambda obj: shapes)
    with pytest.raises(jax_ops.DistributedOperationException) as jax_error:
        jax_ops.gather(torch.ones(2, 3).numpy())
    want = str(jax_error.value).replace("accelerate_tpu.utils", "accelerate_tpu_torch.utils")
    assert [r["debug_error"] for r in reports] == [want, want]


@pytest.mark.parametrize("via", ["flags", "config"])
def test_async_and_sharded_save_reach_the_launched_workers(tmp_path, via):
    """``launch --async_save --sharded_save`` (or the configuration file's
    keys) at 2 processes: each worker's `Accelerator()` saves
    asynchronously and sharded, as under JAX's launcher; without them,
    neither."""
    if via == "flags":
        argv = ["--async_save", "--sharded_save"]
    else:
        argv = ["--config_file", port_config.write_basic_config(str(tmp_path / "config.yaml"), async_save=True,
                                                                sharded_save=True)]
    result, out = _launch(tmp_path, [*argv, "--cpu", "--num_processes", "2"])
    assert result.returncode == 0, result.stdout + result.stderr
    assert [(r["async_save"], r["sharded_save"]) for r in _reports(out, 2)] == [(True, True)] * 2
    if via == "flags":
        result, out = _launch(tmp_path, ["--cpu"])
        assert result.returncode == 0, result.stdout + result.stderr
        assert (_reports(out, 1)[0]["async_save"], _reports(out, 1)[0]["sharded_save"]) == (False, False)


def test_coordinator_invocations_meet_as_one_group(tmp_path):
    """Two ``launch --coordinator_address 127.0.0.1:P --num_processes 2
    --process_id i`` invocations are ranks 0 and 1 of one group."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = tmp_path / "out"
    out.mkdir()
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch",
                               "--cpu", "--num_processes", "2", "--coordinator_address", f"127.0.0.1:{port}",
                               "--process_id", str(i), "--mixed_precision", "fp16", str(script), str(out), "-1"],
                              env=_cli_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0], [p.stdout.read() for p in procs]
    reports = _reports(out, 2)
    assert [(r["rank"], r["world"], r["backend"], r["mixed_precision"]) for r in reports] == [
        (0, 2, "gloo", "fp16"), (1, 2, "gloo", "fp16")]
    assert all(r["gathered"] == [0.0, 1.0] for r in reports)


def test_a_failing_rank_ends_the_group_with_its_exit_code(tmp_path):
    """Rank 1 exits 3 at once: rank 0, left waiting for it in a collective,
    is ended, and the launcher exits 3."""
    result, out = _launch(tmp_path, ["--cpu", "--num_processes", "2"], fail_rank=1)
    assert result.returncode == 3, result.stdout + result.stderr
    assert not (out / "rank1.json").exists()


def test_a_group_is_torn_down_at_exit_only_after_a_clean_end(monkeypatch):
    """`PartialState`'s exit handler on a one-process gloo group: after a
    failing `sys.exit` status (which the wrapped `sys.exit` keeps) or an
    uncaught exception it leaves the group; after a clean end, every rank
    exiting, it destroys it."""
    from accelerate_tpu_torch import state as port_state

    monkeypatch.setattr(sys, "exit", sys.exit)  # put back after the test
    monkeypatch.setattr(port_state, "_EXIT_STATUSES", [])
    store, group = launchers.hosted_store()
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", **group).items():
        monkeypatch.setenv(k, v)
    _reset_port()
    try:
        PartialState(cpu=True)
        assert torch.distributed.is_initialized() and sys.exit.records_status
        with pytest.raises(SystemExit):
            sys.exit(3)
        port_state._destroy_group_at_exit()
        assert port_state._EXIT_STATUSES == [3] and torch.distributed.is_initialized()
        port_state._EXIT_STATUSES.clear()
        monkeypatch.setattr(sys, "last_exc", RuntimeError("uncaught"), raising=False)
        port_state._destroy_group_at_exit()
        assert torch.distributed.is_initialized()
        monkeypatch.setattr(sys, "last_exc", None)
        port_state._destroy_group_at_exit()
        assert not torch.distributed.is_initialized()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        _reset_port()
        del store


def test_local_processes_terminate_the_rest_after_the_grace(monkeypatch):
    """`LocalProcesses`: when one child fails, the others get `GRACE_S`
    seconds and are then terminated; the group's code is the first
    failure's, and each child got its rank's variables."""
    monkeypatch.setattr(launchers, "GRACE_S", 0.5)
    code = ("import os, sys, time\n"
            "rank = int(os.environ['RANK'])\n"
            "assert os.environ['WORLD_SIZE'] == '3' and os.environ['LOCAL_RANK'] == str(rank)\n"
            "assert os.environ['MASTER_ADDR'] == '127.0.0.1'\n"
            "sys.exit(5) if rank == 2 else time.sleep(60)\n")
    group = launchers.LocalProcesses([sys.executable, "-c", code], dict(os.environ), 3)
    assert group.wait(timeout=60) == 5
    assert [p.returncode for p in group.procs] == [-15, -15, 5]
    ports = {launchers.LocalProcesses([sys.executable, "-c", "pass"], None, 2) for _ in range(2)}
    assert all(g.wait(timeout=60) == 0 for g in ports)


# ------------------------------------------------------------------ notebook_launcher
def test_notebook_launcher_guard_and_precision_check_as_jax(monkeypatch):
    """JAX's guard (a state already exists) and its precision check, with
    the same messages; the mode reaches ``ACCELERATE_TPU_MIXED_PRECISION``."""
    from accelerate_tpu import notebook_launcher as jax_notebook_launcher
    from accelerate_tpu.state import PartialState as JaxPartialState

    monkeypatch.setenv("ACCELERATE_TPU_MIXED_PRECISION", "no")
    messages = []
    for launcher, state in ((jax_notebook_launcher, JaxPartialState), (launchers.notebook_launcher, PartialState)):
        with pytest.raises(ValueError, match="Unknown mixed_precision") as bad:
            launcher(lambda: None, mixed_precision="int4")
        state(cpu=True)  # claim the state in this process
        with pytest.raises(ValueError, match="already exists") as exists:
            launcher(lambda: None)
        messages.append((str(bad.value), str(exists.value)))
        state._reset_state()
    assert messages[0] == messages[1]
    box = {}
    launchers.notebook_launcher(lambda a, b: box.update(sum=a + b), args=(2, 3), mixed_precision="bf16")
    assert box["sum"] == 5 and os.environ["ACCELERATE_TPU_MIXED_PRECISION"] == "bf16"


def test_notebook_launcher_cpu_path_and_card_refusal(monkeypatch):
    """Without a card ``num_processes > 1`` goes to `debug_launcher`, as
    JAX's does on the CPU; with one card, two processes are refused (one
    process a card over NCCL) and one runs in this process."""
    monkeypatch.setenv("ACCELERATE_TPU_MIXED_PRECISION", "no")
    calls = []
    monkeypatch.setattr(launchers, "debug_launcher", lambda f, args=(), num_processes=2: calls.append(num_processes))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    launchers.notebook_launcher(lambda: None, num_processes=2)
    assert calls == [2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card a process"):
        launchers.notebook_launcher(lambda: None, num_processes=2)
    box = {}
    launchers.notebook_launcher(lambda: box.update(ran=True), num_processes=1)
    assert box == {"ran": True} and calls == [2]
