"""The compatibility plugins and the FSDP plugin's offload fields, held to
the JAX package's (`utils/dataclasses.py`, `state.py`), and a launch whose
configuration asks for the offload tiers. About 10 s, most of it one
launched child.

  - `FullyShardedDataParallelPlugin`: every offload field, its default
    from `cpu_offload`, the device names and JAX's error for another one,
    field for field with JAX's plugin, from arguments and from the
    ``ACCELERATE_TPU_FSDP_*`` variables.
  - `DeepSpeedPlugin`: every ZeRO stage under every optimizer and
    parameter offload device lowers to JAX's FSDP plugin, from fields and
    from `hf_ds_config`; ``ACCELERATE_TPU_ZERO_STAGE`` and the accumulation
    variable win over the arguments, as in JAX; stage "auto" raises JAX's
    error.
  - `MegatronLMPlugin`: the same `ParallelismConfig` as JAX's; through the
    `Accelerator` a degree above 1 reaches the port's mesh rules and
    raises, naming its ROADMAP A item 3 bullet; degrees of 1 pass.
  - `Accelerator(deepspeed_plugin=...)` lowers to the state's FSDP plugin
    and the optimizer's tier, as JAX's `AcceleratorState` does.
  - ``launch --config_file F`` with ``fsdp_config: {cpu_offload: true}``:
    the child's `FullyShardedDataParallelPlugin()` holds JAX's fields, and
    its prepared optimizer and model are offloaded.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from accelerate_tpu.commands import config as jax_config
from accelerate_tpu.utils import DeepSpeedPlugin as JaxDeepSpeedPlugin
from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JaxFSDPPlugin
from accelerate_tpu.utils import MegatronLMPlugin as JaxMegatronLMPlugin

import accelerate_tpu_torch as port
from accelerate_tpu_torch.optimizer import DiskOptState, PinnedOptState
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import DeepSpeedPlugin, FullyShardedDataParallelPlugin, MegatronLMPlugin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FSDP_FIELDS = ("sharding_strategy", "cpu_offload", "offload_optimizer_state", "offload_params",
               "offload_optimizer_device", "offload_dir")
ENV_PREFIXES = ("ACCELERATE_TPU_FSDP_", "ACCELERATE_TPU_ZERO_STAGE", "ACCELERATE_TPU_MEGATRON_",
                "ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS", "ACCELERATE_TPU_USE_FSDP")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for key in list(os.environ):
        if key.startswith(ENV_PREFIXES):
            monkeypatch.delenv(key)
    AcceleratorState._reset_state()
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()


def _fields(plugin, names=FSDP_FIELDS):
    return {name: getattr(plugin, name) for name in names}


FSDP_CASES = {
    "defaults": {},
    "cpu_offload": dict(cpu_offload=True),
    "cpu_offload_state_off": dict(cpu_offload=True, offload_optimizer_state=False),
    "params_only": dict(offload_params=True),
    "state_only": dict(offload_optimizer_state=True),
    "device_cpu": dict(offload_optimizer_device="cpu"),
    "device_pinned_host": dict(offload_optimizer_device="pinned_host"),
    "device_disk": dict(offload_optimizer_device="disk", offload_dir="/tmp/optstate"),
    "device_nvme": dict(offload_optimizer_device="nvme"),
    "device_upper": dict(offload_optimizer_device="NVMe", sharding_strategy="SHARD_GRAD_OP"),
}


@pytest.mark.parametrize("case", sorted(FSDP_CASES))
def test_fsdp_offload_fields_are_jaxs(case):
    kwargs = FSDP_CASES[case]
    assert _fields(FullyShardedDataParallelPlugin(**kwargs)) == _fields(JaxFSDPPlugin(**kwargs))


def test_fsdp_offload_device_refused_with_jaxs_error():
    with pytest.raises(ValueError) as jax_error:
        JaxFSDPPlugin(offload_optimizer_device="tape")
    with pytest.raises(ValueError) as port_error:
        FullyShardedDataParallelPlugin(offload_optimizer_device="tape")
    assert str(port_error.value) == str(jax_error.value)


ENVS = {
    "offload_params": {"ACCELERATE_TPU_FSDP_OFFLOAD_PARAMS": "true"},
    "device_and_dir": {"ACCELERATE_TPU_FSDP_OFFLOAD_OPTIMIZER_DEVICE": "disk",
                       "ACCELERATE_TPU_FSDP_OFFLOAD_DIR": "/tmp/from_env"},
    "device_cpu": {"ACCELERATE_TPU_FSDP_OFFLOAD_OPTIMIZER_DEVICE": "cpu", "ACCELERATE_TPU_FSDP_OFFLOAD_PARAMS": "0"},
}


@pytest.mark.parametrize("case", sorted(ENVS))
def test_fsdp_offload_env_protocol_is_jaxs(monkeypatch, case):
    for key, value in ENVS[case].items():
        monkeypatch.setenv(key, value)
    assert _fields(FullyShardedDataParallelPlugin()) == _fields(JaxFSDPPlugin())


DEVICES = (None, "none", "cpu", "nvme")


@pytest.mark.parametrize("param_device", DEVICES)
@pytest.mark.parametrize("optimizer_device", DEVICES)
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_deepspeed_lowering_is_jaxs(stage, optimizer_device, param_device):
    """Every stage x optimizer device x parameter device: the same FSDP
    plugin as JAX's, from the fields and from a ds_config."""
    fields = dict(zero_stage=stage, offload_optimizer_device=optimizer_device, offload_param_device=param_device)
    assert _fields(DeepSpeedPlugin(**fields).to_fsdp_plugin()) == _fields(JaxDeepSpeedPlugin(**fields).to_fsdp_plugin())
    zero = {"stage": stage}
    if optimizer_device is not None:
        zero["offload_optimizer"] = {"device": optimizer_device}
    if param_device is not None:
        zero["offload_param"] = {"device": param_device}
    cfg = {"zero_optimization": zero, "gradient_accumulation_steps": 4, "gradient_clipping": "auto"}
    port_ds, jax_ds = DeepSpeedPlugin(hf_ds_config=cfg), JaxDeepSpeedPlugin(hf_ds_config=cfg)
    names = ("zero_stage", "offload_optimizer_device", "offload_param_device", "gradient_accumulation_steps",
             "gradient_clipping")
    assert _fields(port_ds, names) == _fields(jax_ds, names)
    assert _fields(port_ds.to_fsdp_plugin()) == _fields(jax_ds.to_fsdp_plugin())


def test_deepspeed_env_protocol_and_auto_stage(monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_ZERO_STAGE", "3")
    monkeypatch.setenv("ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS", "4")
    names = ("zero_stage", "gradient_accumulation_steps")
    assert _fields(DeepSpeedPlugin(zero_stage=1), names) == _fields(JaxDeepSpeedPlugin(zero_stage=1), names) == {
        "zero_stage": 3, "gradient_accumulation_steps": 4}
    monkeypatch.delenv("ACCELERATE_TPU_ZERO_STAGE")
    cfg = {"zero_optimization": {"stage": "auto"}}
    with pytest.raises(ValueError) as jax_error:
        JaxDeepSpeedPlugin(hf_ds_config=cfg).to_fsdp_plugin()
    with pytest.raises(ValueError) as port_error:
        DeepSpeedPlugin(hf_ds_config=cfg).to_fsdp_plugin()
    assert str(port_error.value) == str(jax_error.value)


MEGATRON = {
    "defaults": {},
    "tp": dict(tp_degree=2),
    "pp": dict(pp_degree=2),
    "sp_default": dict(tp_degree=2, sequence_parallelism=True),
    "sp_degree": dict(sequence_parallelism=True, sequence_parallel_degree=4),
    "ep": dict(expert_parallel_degree=2),
}
#: The ROADMAP A item 3 bullet each Megatron degree waits for in the port
#: ("tp" runs since tensor parallel: the "model" axis).
MEGATRON_BULLETS = {"pp": "pipelines", "sp_default": "sequence parallel", "sp_degree": "sequence parallel",
                    "ep": "expert sharding"}


@pytest.mark.parametrize("case", sorted(MEGATRON))
def test_megatron_lowering_is_jaxs_and_unported_degrees_refused(case):
    kwargs = MEGATRON[case]
    assert (dataclasses.asdict(MegatronLMPlugin(**kwargs).to_parallelism_config())
            == dataclasses.asdict(JaxMegatronLMPlugin(**kwargs).to_parallelism_config()))
    if case == "defaults":
        acc = port.Accelerator(cpu=True, megatron_lm_plugin=MegatronLMPlugin())
        assert acc.state.parallelism_config.model == 1 and acc.state.megatron_lm_plugin is not None
        return
    if case == "tp":
        # As JAX's `Accelerator`: the plugin lowers to a "model" axis of 2.
        # JAX's one process spans its 8 CPU devices with it; the port's one
        # process has no group, so its mesh (and the split) waits for a
        # world of at least 2 (`tests/test_torch_tp_training.py`).
        from accelerate_tpu import Accelerator as JaxAccelerator
        from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState

        acc = port.Accelerator(cpu=True, megatron_lm_plugin=MegatronLMPlugin(**kwargs))
        JaxAcceleratorState._reset_state()
        try:
            jax_acc = JaxAccelerator(megatron_lm_plugin=JaxMegatronLMPlugin(**kwargs))
            assert (dataclasses.asdict(acc.state.parallelism_config)
                    == dataclasses.asdict(jax_acc.state.parallelism_config))
            assert jax_acc.state.mesh.shape["model"] == 2
        finally:
            JaxAcceleratorState._reset_state()
        assert acc.state.parallelism_config.model == 2 and acc.mesh is None
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP A item 3, {MEGATRON_BULLETS[case]}"):
        port.Accelerator(cpu=True, megatron_lm_plugin=MegatronLMPlugin(**kwargs))


def test_megatron_env_protocol_is_jaxs(monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_MEGATRON_TP_DEGREE", "2")
    monkeypatch.setenv("ACCELERATE_TPU_MEGATRON_PP_DEGREE", "3")
    names = ("tp_degree", "pp_degree")
    assert _fields(MegatronLMPlugin(), names) == _fields(JaxMegatronLMPlugin(), names) == {"tp_degree": 2,
                                                                                         "pp_degree": 3}


@pytest.mark.parametrize("device,tier", [("cpu", PinnedOptState), ("nvme", DiskOptState), ("none", None)])
def test_accelerator_lowers_the_deepspeed_plugin(device, tier):
    """`Accelerator(deepspeed_plugin=...)`: the state's FSDP plugin is the
    lowering (an FSDP plugin given beside it wins, as in JAX), and the
    prepared optimizer takes its tier."""
    ds = DeepSpeedPlugin(hf_ds_config={"zero_optimization": {"stage": 2, "offload_optimizer": {"device": device}}})
    acc = port.Accelerator(cpu=True, deepspeed_plugin=ds)
    assert acc.state.deepspeed_plugin is ds
    assert _fields(acc.state.fsdp_plugin) == _fields(ds.to_fsdp_plugin())
    model = torch.nn.Linear(4, 4)
    _, popt = acc.prepare(model, torch.optim.AdamW(model.parameters()))
    assert (None if popt.offload is None else type(popt.offload)) is tier
    if isinstance(popt.offload, DiskOptState):
        popt.offload.close()
        assert not os.path.exists(popt.offload.directory)  # its own temporary directory goes with it
    AcceleratorState._reset_state()
    given = FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD")
    acc = port.Accelerator(cpu=True, deepspeed_plugin=ds, fsdp_plugin=given)
    assert acc.state.fsdp_plugin is given


CHILD = textwrap.dedent('''
    import json, sys
    import torch
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.utils import FullyShardedDataParallelPlugin

    acc = Accelerator()
    plugin = acc.state.fsdp_plugin
    model = torch.nn.Linear(4, 4)
    pmodel, popt = acc.prepare(model, torch.optim.AdamW(model.parameters()))
    names = ("sharding_strategy", "cpu_offload", "offload_optimizer_state", "offload_params",
             "offload_optimizer_device", "offload_dir")
    report = {n: getattr(plugin, n) for n in names}
    report.update(tier=popt.offload.tier, offload_params=pmodel.offload_params,
                  fresh={n: getattr(FullyShardedDataParallelPlugin(), n) for n in names})
    with open(sys.argv[1], "w") as f:
        json.dump(report, f)
''')


def test_launched_cpu_offload_reaches_the_childs_plugin(tmp_path, monkeypatch):
    """``launch --cpu --config_file F`` of a script, F written by JAX's
    `write_basic_config` with ``fsdp_config: {cpu_offload: true}``: the
    child's plugin holds JAX's fields under the same variables, and its
    optimizer and model are offloaded to host memory."""
    fsdp_config = {"sharding_strategy": "NO_SHARD", "cpu_offload": True}
    path = jax_config.write_basic_config(str(tmp_path / "config.yaml"), fsdp_config=fsdp_config)
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    env = {k: v for k, v in os.environ.items() if not k.startswith(ENV_PREFIXES)}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    run = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch", "--cpu",
                          "--config_file", path, str(script), str(tmp_path / "report.json")],
                         capture_output=True, text=True, timeout=180, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    report = json.loads((tmp_path / "report.json").read_text())
    monkeypatch.setenv("ACCELERATE_TPU_FSDP_SHARDING_STRATEGY", "NO_SHARD")
    monkeypatch.setenv("ACCELERATE_TPU_FSDP_OFFLOAD_PARAMS", "true")
    want = _fields(JaxFSDPPlugin())
    assert {n: report[n] for n in FSDP_FIELDS} == want == report["fresh"]
    assert want["offload_params"] and want["offload_optimizer_state"]
    assert report["tier"] == "pinned_host" and report["offload_params"] is True
