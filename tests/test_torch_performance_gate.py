"""The port's launched quality gate
(`accelerate_tpu_torch/test_utils/scripts/test_performance.py`), on the
CPU, as JAX's `tests/test_integration_gates.py` runs its own. About 280 s:
the full `text_pair` recipe in one process (about 140 s: 14 epochs of
bert-tiny in bf16 on two threads), the ragged `token_parity` eval, and one
``accelerate-tpu-torch launch --cpu --num_processes 2`` running one epoch of
each strategy in turn (about 70 s). The wrong-lr mutation is
`tests/test_torch_performance_gate_mutation.py`.

  - "dp", the full recipe (14 epochs, AdamW 3e-4, decay 0.01, global batch
    32, sampler seed 7, bf16): dev accuracy at least 0.82, gathered count
    128, "Performance gate passed", and JAX's JSON keys.
  - `token_parity`: 91 eval rows over batches of 32, so the last batch is
    padded; the gathered count is exactly 91 (the script raises otherwise).
  - Each strategy launched at world 2 over gloo for one epoch: JAX's fast
    tier (the strategy and 2 processes in the JSON line, a finite final
    loss below 1.0, an accuracy in [0, 1]).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from accelerate_tpu.test_utils.scripts import test_performance as jax_gate
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.test_utils import testing
from accelerate_tpu_torch.test_utils.scripts import test_performance as gate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSON_KEYS = {"strategy", "task", "accuracy", "final_loss", "peak_memory_mb", "n_devices"}


def _reset_port():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


@pytest.fixture(autouse=True)
def two_threads_one_process(monkeypatch):
    for key in ("ACCELERATE_TPU_MIXED_PRECISION", "ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS"):
        monkeypatch.delenv(key, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    _reset_port()
    yield
    _reset_port()
    torch.set_num_threads(threads)


def _payload(out: str) -> dict:
    return next(json.loads(line) for line in out.splitlines() if line.startswith("{"))


def test_dp_clears_the_floor_on_the_full_recipe(capsys):
    result = gate.main(["--cpu"])
    out = capsys.readouterr().out
    assert "Performance gate passed: dp" in out
    payload = _payload(out)
    assert set(payload) == JSON_KEYS and payload == result
    assert payload["task"] == "text_pair" and payload["n_devices"] == 1 and payload["peak_memory_mb"] is None
    assert payload["accuracy"] >= 0.82 and payload["final_loss"] < 0.5


def test_the_fixture_and_the_tasks_are_jaxs():
    """The port's copies of JAX's data helpers give JAX's rows."""
    data_dir = gate.find_text_pair_dir()
    assert os.path.samefile(data_dir, jax_gate.find_text_pair_dir())
    for split, n in (("train", 6144), ("dev", 128)):
        ours, theirs = gate.load_text_pair(data_dir, split), jax_gate.load_text_pair(data_dir, split)
        assert len(ours) == len(theirs) == n
        for a, b in zip(ours, theirs):
            assert all((a[k] == b[k]).all() for k in b)
    ours, theirs = gate.make_dataset(91, 32, 30522, seed=1), jax_gate.make_dataset(91, 32, 30522, seed=1)
    assert all((a[k] == b[k]).all() for a, b in zip(ours, theirs) for k in b)


def test_the_gate_trains_the_cpus_draw_on_every_device(monkeypatch, capsys):
    """The gate's model is `create_bert_model`'s seed-0 draw on the CPU,
    moved to the run's device: one model on every device, as JAX's
    `jax.random.key(0)` is (the floor holds for some draws only)."""
    import accelerate_tpu_torch.models as models

    asked = []
    real = models.create_bert_model
    monkeypatch.setattr(models, "create_bert_model",
                        lambda *a, **kw: asked.append(dict(kw)) or real(*a, **kw))
    gate.main(["--cpu", "--task", "token_parity", "--epochs", "1", "--performance_lower_bound", "0.0"])
    capsys.readouterr()
    assert asked == [{"device": "cpu"}]


def test_token_parity_gathers_the_ragged_eval_exactly(capsys):
    result = gate.main(["--cpu", "--task", "token_parity", "--mixed_precision", "no"])
    assert result["task"] == "token_parity" and result["accuracy"] >= 0.82
    assert "Performance gate passed" in capsys.readouterr().out


DRIVER = textwrap.dedent('''
    import json, os, sys
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.test_utils.scripts import test_performance

    out_dir = sys.argv[1]
    for strategy in test_performance.STRATEGIES:
        AcceleratorState._reset_state()
        GradientState._reset_state()
        result = test_performance.main(["--strategy", strategy, "--epochs", "1", "--performance_lower_bound", "0.0"])
        if int(os.environ["RANK"]) == 0:
            with open(os.path.join(out_dir, strategy + ".json"), "w") as f:
                json.dump(result, f)
''')


def test_each_strategy_launches_at_world_2(tmp_path):
    script = tmp_path / "gates.py"
    script.write_text(DRIVER)
    env = testing.cpu_env()
    env.pop("ACCELERATE_TPU_MIXED_PRECISION", None)
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch", "--cpu",
           "--num_processes", "2", str(script), str(tmp_path)]
    result = subprocess.run(cmd, capture_output=True, text=True, timeout=900, env=env)
    assert result.returncode == 0, result.stderr[-4000:]
    for strategy in gate.STRATEGIES:
        payload = json.loads((tmp_path / f"{strategy}.json").read_text())
        assert set(payload) == JSON_KEYS
        assert payload["strategy"] == strategy and payload["n_devices"] == 2
        assert payload["final_loss"] is not None and payload["final_loss"] < 1.0
        assert 0.0 <= payload["accuracy"] <= 1.0
    assert result.stdout.count("Performance gate passed") == len(gate.STRATEGIES)
