"""The port's twins of `examples/cv_example.py` and of the `by_feature`
memory, early-stopping and tracking scripts
(`accelerate_tpu_torch/examples/`), each held to the JAX script on the CPU.
About 60 s on one torch thread (most of it the JAX scripts).

Tolerances:
  - `SmallConvNet` from JAX's initial weights: logits within atol 1e-5,
    f32 (the same convolutions; the sums run in another order).
  - The twins' per-epoch losses against the JAX scripts' at f32, from the
    same initial weights: rtol 1e-4 (both run the same f32 operations;
    Adam's normalised update carries the order of the sums into the
    weights); accuracies, batch sizes, stopping epochs and the printed
    lines' other text exactly. The convnet runs 12 steps (128 samples,
    batch 32, 3 epochs), where every step's loss agrees within 1e-5; over
    longer runs the rounding differences grow step by step as ReLU patterns
    part, and no fixed f32 tolerance holds.
  - Batches: `SimpleDataLoader` over the example's indices against JAX's
    `NativeArrayLoader`: equal, value for value.
"""

import argparse
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import bert as jax_bert
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch.examples import cv_example as twin
from accelerate_tpu_torch.examples import nlp_example
from accelerate_tpu_torch.examples.by_feature import early_stopping as twin_early
from accelerate_tpu_torch.examples.by_feature import memory as twin_memory
from accelerate_tpu_torch.examples.by_feature import tracking as twin_tracking
from accelerate_tpu_torch.models import bert as port_bert
from accelerate_tpu_torch.state import AcceleratorState, GradientState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = dict(rtol=1e-4, atol=0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset():
    for cls in (AcceleratorState, GradientState, JaxAcceleratorState, JaxGradientState, JaxPartialState):
        cls._reset_state()


@pytest.fixture(autouse=True)
def reset_state():
    _reset()
    yield
    _reset()


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples", relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_cv():
    return _load("cv_example.py", "jax_cv_example")


def _jax_params(jax_cv, seed):
    module = jax_cv.SmallConvNet()
    params = module.init(jax.random.key(seed), jnp.zeros((1, twin.IMAGE_SIZE, twin.IMAGE_SIZE, 3)))
    return module, jax.tree_util.tree_map(np.asarray, params)


def _port_from(params):
    model = twin.SmallConvNet()
    model.load_state_dict(twin.smallconvnet_state_dict_from_flax(params))
    return model


def test_small_convnet_matches_jax_logits(jax_cv):
    """JAX's initial weights carried across: the same logits, on inputs of
    the example's size and on an odd size (flax's SAME padding puts the odd
    pixel after the image at every stride-2 layer)."""
    module, params = _jax_params(jax_cv, 42)
    model = _port_from(params)
    for size in (32, 29):
        x = np.random.default_rng(size).normal(size=(3, size, size, 3)).astype(np.float32)
        with torch.no_grad():
            got = model(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(module.apply(params, x)), atol=1e-5, rtol=0)
    assert twin.create_model(42, device="cpu").state_dict().keys() == model.state_dict().keys()


def test_dataset_and_batches_are_jax_examples(jax_cv):
    """The twin's data equal JAX's example's, and `SimpleDataLoader` over the
    example's indices gives `NativeArrayLoader`'s batches."""
    from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
    from accelerate_tpu.native.loader import NativeArrayLoader

    args = argparse.Namespace(train_size=96, eval_size=40, batch_size=32, seed=42)
    ours = twin.get_dataset(args.train_size, seed=0)
    theirs = jax_cv.get_dataset(args.train_size, seed=0)
    for key in ("pixel_values", "labels"):
        np.testing.assert_array_equal(ours.columns[key], theirs.columns[key])
        assert ours.columns[key].dtype == theirs.columns[key].dtype
    train_dl, eval_dl = twin.get_dataloaders(args)
    perm = np.random.default_rng(args.seed).permutation(args.train_size)
    native = {"train": NativeArrayLoader(theirs, JaxBatchSampler(perm.tolist(), 32)),
              "eval": NativeArrayLoader(jax_cv.get_dataset(40, seed=1), JaxBatchSampler(range(40), 32))}
    for ours_dl, theirs_dl in ((train_dl, native["train"]), (eval_dl, native["eval"])):
        got, expect = list(ours_dl), list(theirs_dl)
        assert len(got) == len(expect) == len(ours_dl)
        for a, b in zip(got, expect):
            for key in ("pixel_values", "labels"):
                np.testing.assert_array_equal(a[key], np.asarray(b[key]))


LINE = re.compile(r"epoch (\d+): loss ([0-9.]+) accuracy ([0-9.]+)")


def test_cv_twin_trains_like_the_jax_example(jax_cv, monkeypatch, capsys):
    """Both `training_function`s at f32, from JAX's initial weights: each
    epoch's last loss within rtol 1e-4 (every step's within 1e-5), the
    printed accuracies equal."""
    import accelerate_tpu_torch as port

    args = dict(mixed_precision="no", batch_size=32, lr=2e-3, epochs=3, seed=42, train_size=128, eval_size=64)
    losses = {}
    for side, cls in (("jax", jax_cv.Accelerator), ("port", port.Accelerator)):
        seen = losses[side] = []
        real = cls.backward
        monkeypatch.setattr(cls, "backward", lambda self, *a, real=real, seen=seen, **kw: seen.append(
            float(real(self, *a, **kw))) or torch.tensor(seen[-1]))
    jax_accuracy = jax_cv.training_function(argparse.Namespace(**args))
    jax_lines = LINE.findall(capsys.readouterr().out)
    _, params = _jax_params(jax_cv, args["seed"])
    monkeypatch.setattr(twin, "create_model", lambda seed, device=None: _port_from(params))
    _reset()
    port_args = argparse.Namespace(**args, cpu=True)
    accuracy = twin.training_function(port_args)
    lines = LINE.findall(capsys.readouterr().out)
    steps = args["train_size"] // args["batch_size"]
    assert len(lines) == len(jax_lines) == args["epochs"]
    np.testing.assert_allclose([h["loss"] for h in port_args.history], losses["jax"][steps - 1::steps], **LOSS)
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    assert [a for _, _, a in lines] == [a for _, _, a in jax_lines]
    assert accuracy == jax_accuracy


# ------------------------------------------------------------------ the by_feature twins
@pytest.fixture(scope="module")
def bert_params():
    model = jax_bert.create_bert_model(jax_bert.bert_tiny(), seq_len=nlp_example.MAX_LEN)
    return jax.tree_util.tree_map(np.asarray, model.params)


def _bert_from_jax(params):
    def create(config, device=None, **kwargs):
        model = port_bert.create_bert_model(config, device=device)
        model.load_state_dict(port_bert.bert_state_dict_from_flax(params, config))
        return model

    return create


NUMBER = re.compile(r"-?\d+\.\d+")


def _compare_printed(got: str, expect: str):
    """The lines equal with every decimal number compared at rtol 1e-4 (the
    numbers are printed to 3 or 4 places: a difference past the printed
    digits shows as one unit of the last place)."""
    got_lines, expect_lines = got.strip().splitlines(), expect.strip().splitlines()
    assert len(got_lines) == len(expect_lines), (got, expect)
    for a, b in zip(got_lines, expect_lines):
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b), (a, b)
        for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
            places = len(y.split(".")[1])
            assert abs(float(x) - float(y)) <= max(1e-4 * abs(float(y)), 10.0 ** -places) + 1e-12, (a, b)


def test_memory_twin_prints_the_jax_scripts_results(monkeypatch, capsys, bert_params):
    """At `tests/test_examples.py`'s size (64 samples, batch 64): the same
    attempts, epoch loss and batch size."""
    module = _load("by_feature/memory.py", "jax_memory_example")
    module.training_function(argparse.Namespace(batch_size=64, lr=5e-4, epochs=1, seed=42, train_size=64))
    expect = capsys.readouterr().out
    monkeypatch.setattr(twin_memory, "create_bert_model", _bert_from_jax(bert_params))
    _reset()
    used = twin_memory.training_function(twin_memory.parse_args(["--cpu", "--train_size", "64"]))
    got = capsys.readouterr().out
    _compare_printed(got, expect)
    assert used == 64 and "Trained with batch size 64" in got


def test_early_stopping_twin_stops_where_the_jax_script_does(monkeypatch, capsys, bert_params):
    """`tests/test_examples.py`'s run (64 + 32 samples, 6 epochs, patience
    1), f32 on both sides: the same per-epoch losses and the same stopping
    epoch; the trigger is clear after it fired."""
    module = _load("by_feature/early_stopping.py", "jax_early_stopping_example")
    module.training_function(argparse.Namespace(mixed_precision="no", batch_size=16, lr=5e-4, epochs=6, patience=1,
                                                seed=42, train_size=64, eval_size=32))
    expect = capsys.readouterr().out
    monkeypatch.setattr(twin_early, "create_bert_model", _bert_from_jax(bert_params))
    _reset()
    result = twin_early.training_function(twin_early.parse_args(
        ["--cpu", "--mixed_precision", "no", "--train_size", "64", "--eval_size", "32", "--epochs", "6",
         "--patience", "1"]))
    got = capsys.readouterr().out
    _compare_printed(got, expect)
    assert "early stopping at epoch" in got
    assert result["stopped_at"] is not None and result["trigger_after"] is False


def test_tracking_twin_logs_the_jax_scripts_metrics(tmp_path, monkeypatch, capsys, bert_params):
    """`tests/test_examples.py`'s run (64 samples), JSON tracker: the same
    printed accuracies and the same logged records (train loss at rtol
    1e-4, accuracy, epoch and step exactly)."""
    module = _load("by_feature/tracking.py", "jax_tracking_example")
    module.training_function(argparse.Namespace(log_with="json", batch_size=32, lr=5e-4, epochs=2, seed=42,
                                                train_size=64, eval_size=64, output_dir=str(tmp_path / "jax")))
    expect = capsys.readouterr().out
    monkeypatch.setattr(twin_tracking, "create_bert_model", _bert_from_jax(bert_params))
    _reset()
    logged = twin_tracking.training_function(twin_tracking.parse_args(
        ["--cpu", "--train_size", "64", "--output_dir", str(tmp_path / "port")]))
    got = capsys.readouterr().out
    assert got == expect
    records = []
    for side in ("port", "jax"):
        with open(tmp_path / side / "tracking_example" / "metrics.jsonl") as f:
            records.append([json.loads(line) for line in f])
    mine, theirs = records
    assert [(r["step"], r["epoch"], r["accuracy"]) for r in mine] == [(r["step"], r["epoch"], r["accuracy"]) for r in theirs]
    np.testing.assert_allclose([r["train_loss"] for r in mine], [r["train_loss"] for r in theirs], **LOSS)
    assert [r["epoch"] for r in logged] == [0, 1]
