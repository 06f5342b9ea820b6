"""The port's twins of `examples/by_feature/deepspeed_with_config_support.py`
and `examples/by_feature/local_sgd.py`, each held on the CPU to the JAX
script's printed lines, as `tests/test_torch_cv_example.py` holds the other
twins (JAX's initial BERT weights carried in, f32, every printed number at
rtol 1e-4). About 40 s: the JAX scripts, one spawn of 2 processes.

  - The DeepSpeed twin under JAX's default ds_config (stage 2 ->
    SHARD_GRAD_OP, accumulation 2 printed, clipping 1.0): JAX's lines. The
    same twin under a ds_config that offloads the optimizer to "cpu" (the
    pinned host tier) and to "nvme" (the disk tier) prints the same losses
    bit for bit.
  - The LocalSGD twin at one process (LocalSGD off: synced data parallel)
    against JAX's script on one device, and at 2 processes (batch 16 a
    process) against JAX's script over a data axis of 2 (its global batch
    of 32; its `Accelerator` given a mesh of 2 of the 8 CPU devices), K=3
    over 2 epochs of 4 steps: the first epoch's loss is read between two
    averages, the second's after one.
"""

import argparse
import json
import os
import sys

import pytest
import torch

import jax

sys.path.insert(0, os.path.dirname(__file__))

import _torch_dist_workers as workers  # noqa: E402
from test_torch_cv_example import _bert_from_jax, _compare_printed, _load, _reset, bert_params  # noqa: E402,F401

from accelerate_tpu import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from accelerate_tpu.utils import ParallelismConfig as JaxParallelismConfig  # noqa: E402
from accelerate_tpu_torch.examples.by_feature import deepspeed_with_config_support as twin_ds  # noqa: E402
from accelerate_tpu_torch.examples.by_feature import local_sgd as twin_lsgd  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_state():
    _reset()
    yield
    _reset()


def test_deepspeed_twin_prints_the_jax_scripts_lines(tmp_path, monkeypatch, capsys, bert_params):
    module = _load("by_feature/deepspeed_with_config_support.py", "jax_deepspeed_example")
    module.training_function(argparse.Namespace(ds_config=None, mixed_precision="no", batch_size=16, lr=5e-4,
                                                epochs=2, seed=42, train_size=64))
    expect = capsys.readouterr().out
    monkeypatch.setattr(twin_ds, "create_bert_model", _bert_from_jax(bert_params))
    argv = ["--cpu", "--mixed_precision", "no", "--train_size", "64"]
    _reset()
    losses = twin_ds.training_function(twin_ds.parse_args(argv))
    got = capsys.readouterr().out
    _compare_printed(got, expect)
    assert "zero_stage=2 -> SHARD_GRAD_OP, accumulation=2" in got
    for device in ("cpu", "nvme"):
        cfg = dict(twin_ds.DEFAULT_DS_CONFIG, zero_optimization={"stage": 2, "offload_optimizer": {"device": device}})
        path = tmp_path / f"ds_{device}.json"
        path.write_text(json.dumps(cfg))
        _reset()
        offloaded = twin_ds.training_function(twin_ds.parse_args([*argv, "--ds_config", str(path)]))
        assert [float.hex(x) for x in offloaded] == [float.hex(x) for x in losses], device
    capsys.readouterr()


def _jax_on_devices(module, monkeypatch, n):
    """The JAX script's `Accelerator` given a mesh of its first `n` CPU
    devices (the script's own code is unchanged)."""
    def accelerator(**kwargs):
        acc = JaxAccelerator(**kwargs)
        acc.state.set_mesh(jax_build_mesh(JaxParallelismConfig(data=n), devices=jax.devices()[:n]))
        return acc

    monkeypatch.setattr(module, "Accelerator", accelerator)


def test_local_sgd_twin_at_one_process(monkeypatch, capsys, bert_params):
    module = _load("by_feature/local_sgd.py", "jax_local_sgd_example")
    _jax_on_devices(module, monkeypatch, 1)
    args = dict(local_sgd_steps=8, batch_size=32, lr=5e-4, epochs=2, seed=42, train_size=64)
    module.training_function(argparse.Namespace(**args))
    expect = capsys.readouterr().out
    monkeypatch.setattr(twin_lsgd, "create_bert_model", _bert_from_jax(bert_params))
    _reset()
    twin_lsgd.training_function(twin_lsgd.parse_args(["--cpu", "--train_size", "64"]))
    _compare_printed(capsys.readouterr().out, expect)


def test_local_sgd_twin_at_two_processes(tmp_path, monkeypatch, capsys, bert_params):
    module = _load("by_feature/local_sgd.py", "jax_local_sgd_example2")
    _jax_on_devices(module, monkeypatch, 2)
    module.training_function(argparse.Namespace(local_sgd_steps=3, batch_size=32, lr=5e-4, epochs=2, seed=42,
                                                train_size=128))
    expect = capsys.readouterr().out
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    argv = ["--cpu", "--batch_size", "16", "--local_sgd_steps", "3", "--train_size", "128"]
    torch.save({"bert_params": bert_params, "argv": argv}, in_dir / "inputs.pt")
    debug_launcher(workers.local_sgd_example, args=(str(in_dir), str(out_dir)), num_processes=2, timeout=600)
    losses = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert losses[0] == losses[1]
    got = "".join(f"epoch {epoch}: loss {loss:.4f}\n" for epoch, loss in enumerate(losses[0]))
    _compare_printed(got, expect)
