"""The port's command line (`accelerate_tpu_torch/commands/`) held to JAX's
on the CPU. About 12 s (4 s of it one `config --default` run through the
dispatcher in a fresh interpreter).

  - The dispatcher registers `config`, `env`, `launch`, `test` and `trace`.
  - ``config --default`` writes JAX's default file; the questionnaire, over
    scripted answers, gives JAX's keys and values for the same answers (JAX
    asks first for the compute environment, which the port leaves out with
    the pod and cloud questions).
  - Configuration files cross both ways: a file JAX writes reads in the
    port as PyYAML reads it, and a file the port writes loads in JAX's
    `load_config_file` to the dict written; random strings (quotes, colons,
    hashes, escapes, folded lines) read as PyYAML reads them.
  - `env` prints the card facts and JAX's sections for the variables and
    the file.
  - ``trace export``, ``report`` and ``dump`` of one span stream give JAX's
    output.
Everything is exact: dicts, text and JSON.
"""

import argparse
import io
import json
import math
import os
import random
import string
import subprocess
import sys

import pytest
import yaml

from accelerate_tpu.commands import config as jax_config
from accelerate_tpu.commands import env as jax_env
from accelerate_tpu.commands import trace as jax_trace
from accelerate_tpu_torch.commands import accelerate_cli
from accelerate_tpu_torch.commands import config as port_config
from accelerate_tpu_torch.commands import env as port_env
from accelerate_tpu_torch.commands import trace as port_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dispatcher_registers_the_ported_subcommands(monkeypatch, capsys):
    parser = accelerate_cli.get_command_parser()
    subcommands = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    assert sorted(subcommands.choices) == ["config", "convert", "env", "estimate-memory", "launch", "merge", "plan",
                                           "test", "trace"]
    monkeypatch.setattr(sys, "argv", ["accelerate-tpu-torch"])
    with pytest.raises(SystemExit) as empty:
        accelerate_cli.main()
    assert empty.value.code == 1 and "accelerate-tpu-torch <command>" in capsys.readouterr().out


def test_config_default_through_the_cli_writes_jaxs_file(tmp_path):
    """``python -m accelerate_tpu_torch.commands.accelerate_cli config
    --default`` (the dispatcher as a user runs it) writes the dict JAX's
    ``config --default`` writes, at the path ``ACCELERATE_TPU_CONFIG_HOME``
    names."""
    env = dict(os.environ, ACCELERATE_TPU_CONFIG_HOME=str(tmp_path / "home"),
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    result = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "config",
                             "--default"], capture_output=True, text=True, timeout=120, env=env)
    assert result.returncode == 0, result.stderr
    port_file = tmp_path / "home" / "default_config.yaml"
    assert str(port_file) in result.stdout
    jax_file = jax_config.write_basic_config(str(tmp_path / "jax.yaml"))
    assert yaml.safe_load(port_file.read_text()) == yaml.safe_load(open(jax_file).read()) == jax_config.DEFAULT_CONFIG
    assert port_config.DEFAULT_CONFIG == jax_config.DEFAULT_CONFIG


def _answer(monkeypatch, answers):
    answers = list(answers)
    monkeypatch.setattr(sys, "stdin", io.StringIO())  # not a TTY: the numbered menu
    monkeypatch.setattr("builtins.input", lambda prompt="": answers.pop(0))
    return answers


FLOWS = {
    "defaults": [""] * 8,
    "full": ["y", "-1", "4", "1", "2", "1", "1",  # mesh: data fsdp model seq expert stage
             "y", "1", "2048", "y", "y", "0",  # FSDP: SHARD_GRAD_OP, min params, offload, remat, SHARDED
             "0", "256",  # ring attention, block size (seq = 2 enters the section)
             "0", "n", "4", "/tmp/xla-cache", "y"],  # bf16, downcast, accumulation, cache, debug
    "fp16_no_mesh": ["n", "n", "n", "2", "8", "", "n"],
}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_questionnaire_gives_jaxs_keys_for_the_same_answers(monkeypatch, capsys, flow):
    answers = FLOWS[flow]
    left = _answer(monkeypatch, ["0", *answers])  # JAX: "This machine"
    jax_result = jax_config.run_questionnaire()
    assert left == []
    left = _answer(monkeypatch, answers)
    port_result = port_config.run_questionnaire()
    assert left == []
    assert port_result == jax_result
    assert list(port_result) == list(jax_result)


CROSSING = {
    "default": {},
    "questionnaire": dict(mesh={"data": -1, "fsdp": 4, "model": 2, "seq": 2, "expert": 1, "stage": 1},
                          tpu_commands=["pip install -e .", "echo ready"], coordinator_address="10.0.0.2:8476",
                          fsdp_config={"sharding_strategy": "SHARD_GRAD_OP", "min_num_params": 2048,
                                       "cpu_offload": True, "transformer_cls_names_to_wrap": ["LlamaDecoderLayer"]},
                          sequence_parallel_config={"mode": "ring", "block_size": 256},
                          compilation_cache="/tmp/xla-cache", debug=True, grace_period=30.0, restart_backoff=1e-5),
    "strings": dict(empty="", quote="it's", word_true="yes", clock="1:30", octal="0755", hashed="a #b",
                    colon="a: b", dash="-x", star="*x", newlines="a\n\nb c\n", unicode="é ", tab="a\tb",
                    backslash="a\\", long="word " * 40, inf=float("inf"), negative=-3, small=1.5e-7, empty_map={},
                    empty_list=[]),
}


@pytest.mark.parametrize("case", sorted(CROSSING))
def test_config_files_cross_both_ways(tmp_path, case):
    """JAX's file reads in the port as PyYAML reads it; the port's file
    loads in JAX's `load_config_file` to the dict written."""
    overrides = CROSSING[case]
    jax_file = jax_config.write_basic_config(str(tmp_path / "jax.yaml"), **overrides)
    port_file = port_config.write_basic_config(str(tmp_path / "port.yaml"), **overrides)
    written = {**jax_config.DEFAULT_CONFIG, **overrides}
    assert repr(port_config.load_config_file(jax_file)) == repr(yaml.safe_load(open(jax_file).read()))
    assert repr(jax_config.load_config_file(port_file)) == repr(written)
    assert repr(port_config.load_config_file(port_file)) == repr(written)


def test_random_strings_read_as_pyyaml_reads_them():
    """1000 random strings of quotes, colons, hashes, brackets, backslashes,
    tabs, newlines and non-ASCII letters, as values, in a nested map and in
    a list, written by PyYAML (at its default width and folded at width 5)
    and by the port: the port reads each as PyYAML does, and PyYAML reads
    the port's as written."""
    rnd = random.Random(0)
    alphabet = string.ascii_letters + string.digits + " :#-'\"_./@!&*[]{},?%|>=+~`\\\n\té"
    for _ in range(1000):
        text = "".join(rnd.choice(alphabet) for _ in range(rnd.randint(0, 14)))
        config = {"k": text, "m": {"v": text}, "l": [text, text]}
        for dumped in (yaml.safe_dump(config, sort_keys=False), yaml.safe_dump(config, sort_keys=False, width=5),
                       port_config.dump_config(config)):
            assert repr(port_config.parse_config(dumped)) == repr(yaml.safe_load(dumped)), dumped
        assert yaml.safe_load(port_config.dump_config(config)) == config


def test_plain_scalars_resolve_as_pyyaml():
    for text in ("~", "null", "yes", "On", "off", "TRUE", "12", "-0x1F", "0b101", "0755", "1_000", "190:20:30",
                 "1.5", "1e3", "1.0e+3", ".5", "-.inf", ".NaN", "6.8523015e+5", "1:30.5", "y", "n", "abc"):
        want, got = yaml.safe_load(f"k: {text}")["k"], port_config.parse_config(f"k: {text}")["k"]
        assert type(got) is type(want) and (got == want or (isinstance(want, float) and math.isnan(want))), text


def test_a_flow_style_file_is_refused_with_a_reason():
    with pytest.raises(ValueError, match="block-style"):
        port_config.parse_config("mesh: {data: -1}\n")


def test_env_prints_the_card_facts_and_jaxs_sections(tmp_path, monkeypatch, capsys):
    config = port_config.write_basic_config(str(tmp_path / "c.yaml"))
    monkeypatch.setenv("ACCELERATE_TPU_MIXED_PRECISION", "bf16")
    monkeypatch.setenv("ACCELERATE_TPU_DEBUG_MODE", "1")
    info = port_env.env_command(argparse.Namespace(config_file=config))
    port_out = capsys.readouterr().out
    jax_env.env_command(argparse.Namespace(config_file=config))
    jax_out = capsys.readouterr().out
    import torch

    assert info["PyTorch version"] == torch.__version__
    if not torch.cuda.is_available():
        assert info["Card count"] == 0 and info["Card names"] == "none"
    assert "Card name, power limit (nvidia-smi)" in info
    assert port_out.split("- Environment config:")[1] == jax_out.split("- Environment config:")[1]
    assert f"- Config file ({config}):" in port_out


def _span_stream(trace_dir):
    """A span stream written by the port's tracer: nested spans, an event,
    a supervisor crash boundary, and a span left open."""
    from accelerate_tpu_torch.telemetry import FlightRecorder
    from accelerate_tpu_torch.telemetry.tracing import Tracer

    tracer = Tracer(recorder=FlightRecorder(log_dir=str(trace_dir)), trace_id="t-1", category="train")
    with tracer.span("train.step", step=1):
        with tracer.span("checkpoint.save", category="checkpoint", step=1):
            pass
    tracer.event("supervisor.child_exit", category="supervisor", attempt=1, exit_code=1)
    tracer.start_span("serve.request", request_id=7)
    tracer.recorder.close()
    return [str(p) for p in sorted(trace_dir.glob("spans_*.jsonl"))]


def _run(command, args):
    with pytest.raises(SystemExit) as done:
        command(args)
    return done.value.code


def test_trace_export_report_and_dump_give_jaxs_output(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    files = _span_stream(trace_dir)
    assert files
    outputs = {}
    for name, module in (("jax", jax_trace), ("port", port_trace)):
        out = tmp_path / f"{name}.json"
        assert _run(module.trace_export_command, argparse.Namespace(inputs=files, out=str(out))) == 0
        assert capsys.readouterr().out.strip() == str(out)
        assert _run(module.trace_report_command, argparse.Namespace(input=str(trace_dir))) == 0
        report = capsys.readouterr().out
        dumped = tmp_path / f"{name}_dump.json"
        assert _run(module.trace_dump_command, argparse.Namespace(trace_dir=str(trace_dir), out=str(dumped),
                                                                  wait=0.0)) == 0
        capsys.readouterr()
        outputs[name] = (json.loads(out.read_text()), report, json.loads(dumped.read_text()))
    assert outputs["port"][0] == outputs["jax"][0]
    assert outputs["port"][1] == outputs["jax"][1]
    assert "crash/exit boundaries: 1" in outputs["port"][1]
    assert outputs["port"][2] == outputs["jax"][2]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _run(port_trace.trace_report_command, argparse.Namespace(input=str(empty))) == 1
