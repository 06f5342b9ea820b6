"""The port's example twins, part 1: the drift harness over
`accelerate_tpu_torch/examples/by_feature/` (`test_utils/examples.py`), the
schedule-free AdamW against optax's, and the twins of
`examples/complete_nlp_example.py` and `by_feature/checkpointing.py`, each
held to the JAX script on the CPU in process, from JAX's initial weights
carried across. About 45 s on one torch thread (most of it the JAX
scripts). `tests/test_torch_examples_by_feature.py` holds the other
by_feature twins, `tests/test_torch_examples_inference.py` the inference
twins.

Tolerances:
  - The schedule-free optimizer against optax's `schedule_free_adamw` and
    `schedule_free_eval_params` after 12 steps in f32: rtol 1e-6 (they
    agree bit for bit: the port rounds optax's bias correction as XLA does).
  - The twins' printed lines against the JAX scripts' at f32: the text
    equal, every printed number at rtol 1e-4 (one unit of the last printed
    place), as `tests/test_torch_cv_example.py`.
  - A resumed run against the run that was not cut: equal.
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_cv_example import (  # noqa: E402,F401  (fixtures: bert_params, one_torch_thread, reset_state)
    ROOT, _bert_from_jax, _compare_printed, _load, _reset, bert_params, one_torch_thread, reset_state)

from accelerate_tpu_torch.examples import complete_nlp_example as twin_complete  # noqa: E402
from accelerate_tpu_torch.examples.by_feature import checkpointing as twin_ckpt  # noqa: E402
from accelerate_tpu_torch.test_utils.examples import check_example_shape  # noqa: E402
from accelerate_tpu_torch.utils.schedule_free import schedule_free_adamw, schedule_free_eval_params  # noqa: E402

EXAMPLES = os.path.join(ROOT, "examples")
TWINS = os.path.join(ROOT, "accelerate_tpu_torch", "examples")

# ------------------------------------------------------------------ the drift harness
#: JAX's `tests/test_examples.py:FEATURE_MARKERS`, for each by_feature script
#: the port has.
FEATURE_MARKERS = {
    "gradient_accumulation.py": ["accumulate(", "gradient_accumulation_steps"],
    "local_sgd.py": ["LocalSGD"],
    "memory.py": ["find_executable_batch_size"],
    "fsdp.py": ["FullyShardedDataParallelPlugin"],
    "profiler.py": ["profile"],
    "tracking.py": ["init_trackers", "accelerator.log"],
    "checkpointing.py": ["save_state", "load_state"],
    "early_stopping.py": ["set_trigger", "check_trigger"],
    "cross_validation.py": ["gather_for_metrics", "fold"],
    "multi_process_metrics.py": ["gather_for_metrics"],
    "automatic_gradient_accumulation.py": ["find_executable_batch_size", "gradient_accumulation_steps"],
    "schedule_free.py": ["schedule_free_adamw", "schedule_free_eval_params"],
    "deepspeed_with_config_support.py": ["DeepSpeedPlugin", "hf_ds_config"],
    "device_training_loop.py": ["steps_per_call"],
}
#: JAX's by_feature scripts with no twin yet, each beside the ROADMAP item
#: that ports what it needs.
WAITING = {
    "sequence_parallelism.py": "ROADMAP A item 3, sequence parallel",
    "megatron_lm_gpt_pretraining.py": "ROADMAP A item 3, pipelines",
}


def _scripts(directory):
    return {f for f in os.listdir(directory) if f.endswith(".py") and f != "__init__.py"}


def test_example_difference_harness():
    """Every by_feature twin keeps the canonical shape (it imports the nlp
    example's dataset, has a training_function, an argparse main and a
    prepare() call) and exercises its feature; the twins are JAX's scripts
    less those that wait, so a script JAX adds fails here until it has a
    twin or an entry in `WAITING`."""
    from test_examples import FEATURE_MARKERS as JAX_MARKERS

    ours = _scripts(os.path.join(TWINS, "by_feature"))
    theirs = _scripts(os.path.join(EXAMPLES, "by_feature"))
    assert ours == set(FEATURE_MARKERS)
    assert ours | set(WAITING) == theirs and not ours & set(WAITING)
    assert FEATURE_MARKERS == {script: JAX_MARKERS[script] for script in ours}
    problems = {}
    for script in sorted(ours):
        p = check_example_shape(os.path.join(TWINS, "by_feature", script), FEATURE_MARKERS[script])
        if p:
            problems[script] = p
    assert not problems, problems


def test_shape_check_reads_jax_scripts_as_jaxs_does():
    """The port's check gives JAX's verdict on every JAX by_feature script,
    and on a twin with a marker taken out it names the marker."""
    from test_examples import FEATURE_MARKERS as JAX_MARKERS

    from accelerate_tpu.test_utils.examples import check_example_shape as jax_check

    for script, markers in JAX_MARKERS.items():
        path = os.path.join(EXAMPLES, "by_feature", script)
        assert check_example_shape(path, markers) == jax_check(path, markers), script
    problems = check_example_shape(os.path.join(TWINS, "by_feature", "profiler.py"), ["profile", "not_a_marker"])
    assert problems == ["feature marker(s) absent: ['not_a_marker']"]


# ------------------------------------------------------------------ schedule-free AdamW
def _quadratic(params, targets):
    return sum(((params[k] - targets[k]) ** 2 * (1 + i)).sum() for i, k in enumerate(sorted(params)))


@pytest.mark.parametrize("kwargs", [
    dict(learning_rate=1e-2),
    dict(learning_rate=1e-2, warmup_steps=4, weight_decay=0.1),
    dict(learning_rate=0.05, warmup_steps=3, b1=0.95, b2=0.99, eps=1e-6, weight_lr_power=1.0),
], ids=["plain", "warmup-decay", "other-betas"])
def test_schedule_free_adamw_matches_optax(kwargs):
    rng = np.random.default_rng(0)
    init = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float32)}
    targets = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
    tx = optax.contrib.schedule_free_adamw(**kwargs)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    opt = schedule_free_adamw(module.parameters(), **kwargs)
    jtargets = {k: jnp.asarray(v) for k, v in targets.items()}
    ttargets = {k: torch.tensor(v) for k, v in targets.items()}
    for _ in range(12):
        updates, state = tx.update(jax.grad(_quadratic)(params, jtargets), state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        _quadratic(dict(module.named_parameters()), ttargets).backward()
        opt.step()
    eval_params = optax.contrib.schedule_free_eval_params(state, params)
    ours = schedule_free_eval_params(opt, module)
    for k in init:
        np.testing.assert_allclose(getattr(module, k).detach().numpy(), np.asarray(params[k]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(eval_params[k]), rtol=1e-6, atol=0)
        assert not np.array_equal(ours[k].numpy(), getattr(module, k).detach().numpy())


# ------------------------------------------------------------------ complete_nlp_example
def _complete_args(output_dir, **overrides):
    args = dict(mixed_precision="no", batch_size=32, lr=5e-4, epochs=1, seed=42, train_size=128, eval_size=64,
                output_dir=str(output_dir), checkpointing_steps="epoch", resume_from_checkpoint=None,
                with_tracking=False, performance_lower_bound=None)
    args.update(overrides)
    return args


def _port_complete(monkeypatch, bert_params, **args):
    monkeypatch.setattr(twin_complete, "create_bert_model", _bert_from_jax(bert_params))
    _reset()
    ns = argparse.Namespace(**args, cpu=True, history=[])
    accuracy = twin_complete.training_function(ns)
    return accuracy, ns.history


def test_complete_nlp_twin_saves_and_resumes_as_the_jax_script(tmp_path, monkeypatch, capsys, bert_params):
    """`tests/test_examples.py`'s run: one epoch saved by epoch, then a
    resume to two with tracking. The same printed lines (with "resumed
    from") as the JAX script, each side on its own checkpoints."""
    monkeypatch.syspath_prepend(EXAMPLES)
    module = _load("complete_nlp_example.py", "jax_complete_nlp_example")
    first = _complete_args(tmp_path / "jax")
    resumed = dict(epochs=2, resume_from_checkpoint="latest", with_tracking=True)
    module.training_function(argparse.Namespace(**first))
    module.training_function(argparse.Namespace(**_complete_args(tmp_path / "jax", **resumed)))
    expect = capsys.readouterr().out
    _port_complete(monkeypatch, bert_params, **_complete_args(tmp_path / "port"))
    _port_complete(monkeypatch, bert_params, **_complete_args(tmp_path / "port", **resumed))
    got = capsys.readouterr().out
    _compare_printed(got, expect)
    assert "resumed from latest checkpoint: epoch 1, step 0" in got
    assert os.path.exists(tmp_path / "port" / "complete_nlp_example" / "metrics.jsonl")


def test_complete_nlp_twin_resumes_on_the_exact_batch(tmp_path, monkeypatch, capsys, bert_params):
    """A run saving every 3 batches (4 a epoch) dies at its fifth batch and
    resumes from the checkpoint at batch 3, mid-epoch: the second epoch's
    loss and the final accuracy equal the run that was not cut."""
    run = _complete_args(tmp_path / "uncut", epochs=2, checkpointing_steps="3")
    uncut_accuracy, uncut = _port_complete(monkeypatch, bert_params, **run)
    counter = twin_complete.StepCounter

    class Died(Exception):
        pass

    class Dies(counter):
        def __setattr__(self, name, value):
            if name == "overall_step" and value == 5:
                raise Died("the run dies at batch 5")
            super().__setattr__(name, value)

    monkeypatch.setattr(twin_complete, "StepCounter", Dies)
    cut = dict(run, output_dir=str(tmp_path / "cut"))
    with pytest.raises(Died):
        _port_complete(monkeypatch, bert_params, **cut)
    monkeypatch.setattr(twin_complete, "StepCounter", counter)
    accuracy, history = _port_complete(monkeypatch, bert_params, **dict(cut, resume_from_checkpoint="latest"))
    assert "resumed from latest checkpoint: epoch 0, step 3" in capsys.readouterr().out
    assert history[1] == uncut[1] and accuracy == uncut_accuracy


# ------------------------------------------------------------------ by_feature/checkpointing
def test_checkpointing_twin_resumes_as_the_jax_script(tmp_path, monkeypatch, capsys, bert_params):
    """`tests/test_examples.py`'s run (64 samples: one epoch, then a resume
    to two): JAX's lines; the resumed epoch's loss equals an uncut run's."""
    module = _load("by_feature/checkpointing.py", "jax_checkpointing_example")
    args = dict(batch_size=32, lr=5e-4, seed=42, train_size=64)
    module.training_function(argparse.Namespace(**args, epochs=1, output_dir=str(tmp_path / "jax"),
                                                resume_from_checkpoint=None))
    module.training_function(argparse.Namespace(**args, epochs=2, output_dir=str(tmp_path / "jax"),
                                                resume_from_checkpoint="latest"))
    expect = capsys.readouterr().out
    monkeypatch.setattr(twin_ckpt, "create_bert_model", _bert_from_jax(bert_params))
    runs = {}
    for name, argv in (("first", ["--epochs", "1"]), ("resumed", ["--epochs", "2", "--resume_from_checkpoint", "latest"])):
        _reset()
        runs[name] = twin_ckpt.training_function(twin_ckpt.parse_args(
            ["--cpu", "--train_size", "64", "--output_dir", str(tmp_path / "port"), *argv]))
    got = capsys.readouterr().out
    _compare_printed(got, expect)
    assert "resumed from latest checkpoint: epoch 1, step 0" in got
    _reset()
    uncut = twin_ckpt.training_function(twin_ckpt.parse_args(
        ["--cpu", "--train_size", "64", "--epochs", "2", "--output_dir", str(tmp_path / "uncut")]))
    assert runs["first"] + runs["resumed"] == uncut
    capsys.readouterr()
