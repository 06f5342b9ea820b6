"""The port's twin of `examples/nlp_example.py`
(`accelerate_tpu_torch/examples/nlp_example.py`) and the surface it needs
beyond training: the JSON and CSV trackers, `init_trackers`/`log`/
`end_training` and `gather_for_metrics`, each held against the JAX
package's on the same inputs.

Tolerance of the whole example, f32, `bert_tiny` from JAX's own initial
weights, 2 epochs of 4 steps: rtol 1e-4 on each epoch's loss (both run the
same f32 operations; the GEMMs sum in another order, and Adam's normalised
update carries that into the weights), and the same accuracy.
"""

import argparse
import csv
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu_torch as port
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import SimpleDataLoader as JaxLoader
from accelerate_tpu import tracking as jax_tracking
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
from accelerate_tpu.models import bert as jax_bert
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch import tracking
from accelerate_tpu_torch.examples import nlp_example as twin
from accelerate_tpu_torch.models import bert as port_bert
from accelerate_tpu_torch.state import AcceleratorState, GradientState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_nlp_example", os.path.join(ROOT, "examples", "nlp_example.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: a second OpenMP thread was seen to move `torch.exp`
    by about 1e-4 now and then on a shared CPU host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_state():
    for cls in (AcceleratorState, GradientState, JaxAcceleratorState, JaxGradientState, JaxPartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, JaxAcceleratorState, JaxGradientState, JaxPartialState):
        cls._reset_state()


LOG_CALLS = [({"loss": 0.75, "lr": np.float32(5e-4)}, 0), ({"loss": torch.tensor(0.5)}, 1),
             ({"loss": 0.25, "accuracy": 0.875}, 2), ({"note": "done"}, None)]


@pytest.mark.parametrize("name", ["json", "csv"])
def test_trackers_write_jax_files(tmp_path, name):
    """The same `log` calls through `Accelerator(log_with=...)`: the metrics
    file and the stored configuration equal JAX's (JSON records up to their
    wall-clock `time`; the CSV header grows as JAX's does)."""
    config = {"lr": 5e-4, "tiny": True}
    files = {}
    for side, make in (("jax", lambda d: JaxAccelerator(log_with=name, project_dir=d)),
                       ("port", lambda d: port.Accelerator(cpu=True, log_with=name, project_dir=d))):
        accelerator = make(str(tmp_path / side))
        accelerator.init_trackers("run", config=config)
        for values, step in LOG_CALLS:
            accelerator.log({k: (v.numpy() if side == "jax" and isinstance(v, torch.Tensor) else v)
                             for k, v in values.items()}, step=step)
        tracker = accelerator.get_tracker(name)
        assert accelerator.get_tracker(name, unwrap=True) == tracker.path
        accelerator.end_training()
        files[side] = (open(tracker.path).read(), open(os.path.join(tracker.dir, "config.json")).read())
    assert files["port"][1] == files["jax"][1]
    if name == "csv":
        assert files["port"][0] == files["jax"][0]
        assert next(csv.reader(files["port"][0].splitlines())) == ["step", "loss", "lr", "accuracy", "note"]
        return
    strip = [[{k: v for k, v in json.loads(line).items() if k != "time"} for line in text.splitlines()]
             for text in (files["port"][0], files["jax"][0])]
    assert strip[0] == strip[1] and len(strip[0]) == len(LOG_CALLS)


def test_filter_trackers_resolves_names_as_jax_does(tmp_path):
    assert tracking.filter_trackers(None) == []
    assert tracking.filter_trackers("all", str(tmp_path)) == jax_tracking.filter_trackers("all", str(tmp_path))
    mine = tracking.JSONTracker("mine", str(tmp_path))
    assert tracking.filter_trackers([mine, "csv"], str(tmp_path)) == [mine, "csv"]
    for bad in ("bogus", "json"):
        with pytest.raises(ValueError) as error:
            tracking.filter_trackers(bad)
        with pytest.raises(ValueError) as jax_error:
            jax_tracking.filter_trackers(bad)
        assert str(error.value) == str(jax_error.value)
    # wandb is not installed here: skipped with a warning, as JAX does.
    assert tracking.filter_trackers("wandb", str(tmp_path)) == jax_tracking.filter_trackers("wandb", str(tmp_path)) == []


def test_gather_for_metrics_matches_jax():
    """Over a loader whose last batch is short (20 samples, batch 8): JAX
    pads that batch and cuts the repeats off again, the port pads nothing;
    both hand back the same samples, as arrays, dicts and object lists."""
    data = [{"x": np.arange(3, dtype=np.float32) + i, "y": np.int64(i)} for i in range(20)]
    jax_acc = JaxAccelerator()
    jax_out = []
    for batch in jax_acc.prepare(JaxLoader(data, JaxBatchSampler(range(20), 8))):
        gathered = jax_acc.gather_for_metrics({"x": np.asarray(batch["x"]), "y": np.asarray(batch["y"])})
        objects = jax_acc.gather_for_metrics([f"s{int(v)}" for v in np.asarray(batch["y"])], use_gather_object=True)
        jax_out.append((np.asarray(gathered["x"]), np.asarray(gathered["y"]), list(objects)))
    acc = port.Accelerator(cpu=True)
    out = []
    for batch in acc.prepare(port.SimpleDataLoader(data, port.BatchSampler(range(20), 8))):
        gathered = acc.gather_for_metrics(batch)
        objects = acc.gather_for_metrics([f"s{int(v)}" for v in batch["y"]], use_gather_object=True)
        out.append((gathered["x"].numpy(), gathered["y"].numpy(), list(objects)))
    assert [len(b[1]) for b in out] == [8, 8, 4]
    for (x, y, objs), (jx, jy, jobjs) in zip(out, jax_out):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert objs == jobjs
    assert acc.gather(batch["x"]) is batch["x"]


def test_get_dataset_returns_jax_arrays():
    jax_example = _jax_example()
    for vocab, n, seed in ((1023, 16, 0), (30521, 8, 1)):
        got, expect = twin.get_dataset(vocab, n=n, seed=seed), jax_example.get_dataset(vocab, n=n, seed=seed)
        assert len(got) == len(expect) == n
        for a, b in zip(got, expect):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
                assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype


def test_linear_schedule_matches_optax():
    import optax

    mine, theirs = twin.linear_schedule(5e-4, 0.0, 8), optax.linear_schedule(5e-4, 0.0, transition_steps=8)
    np.testing.assert_allclose([mine(s) for s in range(-1, 11)], [float(theirs(s)) for s in range(-1, 11)],
                               rtol=1e-6, atol=1e-12)


def _args(output_dir, **over):
    args = dict(mixed_precision="no", batch_size=16, lr=5e-4, epochs=2, seed=42, train_size=64, eval_size=32,
                output_dir=str(output_dir), tiny=True, performance_lower_bound=None)
    args.update(over)
    return argparse.Namespace(**args)


def _metrics(output_dir):
    with open(os.path.join(output_dir, "nlp_example", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_training_function_matches_jax_example(tmp_path, monkeypatch):
    """The twin's `training_function` and JAX's, f32, `bert_tiny` from JAX's
    initial weights (`create_bert_model(bert_tiny())`, carried across): the
    same per-epoch loss and accuracy."""
    jax_example = _jax_example()
    jax_accuracy = jax_example.training_function(_args(tmp_path / "jax"))

    jmodel = jax_bert.create_bert_model(jax_bert.bert_tiny(), seq_len=twin.MAX_LEN)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)

    def from_jax(config, device=None, **kwargs):
        model = port_bert.create_bert_model(config, device=device)
        model.load_state_dict(port_bert.bert_state_dict_from_flax(params, config))
        return model

    monkeypatch.setattr(twin, "create_bert_model", from_jax)
    for cls in (AcceleratorState, GradientState):
        cls._reset_state()
    accuracy = twin.training_function(_args(tmp_path / "port", cpu=True))
    got, expect = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert [m["step"] for m in got] == [m["step"] for m in expect] == [0, 1]
    np.testing.assert_allclose([m["loss"] for m in got], [m["loss"] for m in expect], rtol=1e-4)
    assert [m["accuracy"] for m in got] == [m["accuracy"] for m in expect]
    assert accuracy == jax_accuracy
    config = json.load(open(tmp_path / "port" / "nlp_example" / "config.json"))
    assert config["cpu"] is True and config["tiny"] is True


def test_example_runs_as_a_module_on_the_cpu(tmp_path):
    """``python -m accelerate_tpu_torch.examples.nlp_example --cpu``: prints
    each epoch's accuracy and writes metrics.jsonl."""
    out = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch.examples.nlp_example", "--cpu", "--mixed_precision", "no",
         "--train_size", "32", "--eval_size", "16", "--batch_size", "16", "--epochs", "1",
         "--output_dir", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"),
    )
    assert out.returncode == 0, out.stderr
    assert "epoch 0: loss" in out.stdout and "accuracy" in out.stdout
    records = _metrics(tmp_path)
    assert len(records) == 1 and np.isfinite(records[0]["loss"]) and 0 <= records[0]["accuracy"] <= 1
