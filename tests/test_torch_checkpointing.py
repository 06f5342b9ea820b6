"""The port's checkpoints (`accelerate_tpu_torch.checkpointing`,
`Accelerator.save_state` / `load_state`, `skip_first_batches`) on the CPU.

The first tests port the JAX package's crash-safety tests
(`tests/test_checkpoint_faults.py`): atomic files, digest-verified
directories, the staged commit, rotation and the fallback past a torn
newest checkpoint. A kill is a `BaseException` raised inside a write, as
a SIGKILL-like exit would leave the save. Then a resumed `llama_tiny` run
is held to the uninterrupted one, bit for bit (the same f32 operations on
the same restored weights and optimizer state, on one torch thread), and
to JAX's losses at `F32_VS_JAX` (atol 1e-4, `test_torch_training.py`'s
tolerance). The data order is JAX's: `SeedableRandomSampler` draws the same
permutations for the same seed, and `skip_first_batches` resumes at the
same batch.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import optax

import accelerate_tpu_torch as port
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import SimpleDataLoader as JaxLoader
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
from accelerate_tpu.data_loader import SeedableRandomSampler as JaxSeedableRandomSampler
from accelerate_tpu.data_loader import skip_first_batches as jax_skip_first_batches
from accelerate_tpu_torch.checkpointing import (
    CHECKPOINT_MANIFEST_NAME,
    LATEST_POINTER_NAME,
    CheckpointCorruptError,
    CheckpointManager,
    atomic_write,
    verify_checkpoint_dir,
)
from accelerate_tpu_torch.data_loader import SeedableRandomSampler, skip_first_batches
from accelerate_tpu_torch.models import llama as port_llama
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import GradScalerKwargs, ProjectConfiguration

from test_torch_training import BETAS, EPS, F32_VS_JAX, LR, WD, _adamw, _data, _port_model, _reset_jax, weights  # noqa: F401


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch CPU thread, as in the other parity files (a second OpenMP
    thread was seen to move `torch.exp` by about 1e-4 now and then)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset_port():
    AcceleratorState._reset_state()
    GradientState._reset_state()


@pytest.fixture(autouse=True)
def reset_port_state():
    _reset_port()
    yield
    _reset_port()


class _Kill(BaseException):
    """A process dying mid-write (not an Exception: nothing may catch it and go on)."""


# ------------------------------------------------------------------ files and directories
def test_atomic_write_keeps_the_previous_content_on_failure(tmp_path):
    target = tmp_path / "state.json"
    atomic_write(target, lambda f: f.write(b"old-complete"))

    def torn_writer(f):
        f.write(b"new-but-")
        raise _Kill("killed mid-write")

    with pytest.raises(_Kill):
        atomic_write(target, torn_writer)
    assert target.read_bytes() == b"old-complete"
    assert os.listdir(tmp_path) == ["state.json"], "temp litter left behind"


def _write_artifacts(names):
    def write_fn(staging):
        for name in names:
            with open(os.path.join(staging, name), "w") as f:
                f.write(f"payload:{name}")

    return write_fn


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_a_damaged_file_fails_verification_and_load(tmp_path, damage):
    """A checkpoint whose `model.pt` is cut in half (or has one byte flipped,
    same length) no longer verifies; `load_state` of it raises instead of
    reading half a file, and `resolve` names it corrupt."""
    accelerator = port.Accelerator(cpu=True)
    pm = accelerator.prepare(port_llama.create_llama_model(port_llama.llama_tiny(), seed=0, device="cpu"))
    path = accelerator.save_state(str(tmp_path / "ckpt"))
    assert verify_checkpoint_dir(path)
    model_file = os.path.join(path, "model.pt")
    data = bytearray(open(model_file, "rb").read())
    if damage == "truncate":
        data = data[: len(data) // 2]
    else:
        data[len(data) // 2] ^= 0xFF
    with open(model_file, "wb") as f:
        f.write(bytes(data))
    assert not verify_checkpoint_dir(path)
    before = [p.clone() for p in pm.parameters()]
    with pytest.raises(CheckpointCorruptError):
        accelerator.load_state(path)
    assert all(torch.equal(a, b) for a, b in zip(before, pm.parameters()))


def test_manager_commit_layout_and_latest_pointer(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    path = manager.save(0, _write_artifacts(["model.pt", "optimizer.pt"]))
    assert os.path.basename(path) == "checkpoint_0"
    assert verify_checkpoint_dir(path)
    with open(os.path.join(str(tmp_path), LATEST_POINTER_NAME)) as f:
        assert f.read() == "checkpoint_0"
    with open(os.path.join(path, CHECKPOINT_MANIFEST_NAME)) as f:
        manifest = json.load(f)
    assert set(manifest["files"]) == {"model.pt", "optimizer.pt"} and manifest["step"] == 0
    assert manager.resolve("latest") == path
    assert CheckpointManager.is_manager_dir(str(tmp_path)) and not CheckpointManager.is_manager_dir(path)


def test_manager_rotation_keeps_last_n(tmp_path):
    manager = CheckpointManager(str(tmp_path), keep_last_n=2)
    for step in range(4):
        manager.save(step, _write_artifacts([f"a{step}.bin"]))
    assert [s for s, _ in manager.checkpoints()] == [2, 3]
    assert manager.resolve("latest").endswith("checkpoint_3")


@pytest.mark.parametrize("artifacts_before_kill", [0, 1, 2])
def test_kill_between_any_two_artifact_writes_never_publishes(tmp_path, artifacts_before_kill):
    """A kill inside the write of each artifact in turn: the checkpoint in
    progress never becomes visible, `latest` keeps resolving to the previous
    verified save, and a retry after reaping the staging litter lands."""
    manager = CheckpointManager(str(tmp_path))
    good = manager.save(0, _write_artifacts(["model.pt", "optimizer.pt"]))

    def torn_writer(f):
        f.write(b"pay")
        raise _Kill("killed mid-save")

    def killed_write_fn(staging):
        for i in range(3):
            atomic_write(os.path.join(staging, f"part{i}.bin"),
                         torn_writer if i == artifacts_before_kill else lambda f: f.write(b"payload"))

    with pytest.raises(_Kill):
        manager.save(1, killed_write_fn)
    assert [s for s, _ in manager.checkpoints()] == [0]
    assert manager.resolve("latest") == good
    with open(os.path.join(str(tmp_path), LATEST_POINTER_NAME)) as f:
        assert f.read() == "checkpoint_0"
    assert any(name.startswith(".tmp-") for name in os.listdir(tmp_path))  # the staging litter
    manager.clean_staging()
    assert not any(name.startswith(".tmp-") for name in os.listdir(tmp_path))
    assert manager.save(1, _write_artifacts(["model.pt"])) != good
    assert [s for s, _ in manager.checkpoints()] == [0, 1]


def test_latest_falls_back_past_a_torn_newest_checkpoint(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    good = manager.save(0, _write_artifacts(["model.pt"]))
    torn = manager.save(1, _write_artifacts(["model.pt"]))
    with open(os.path.join(torn, "model.pt"), "w") as f:
        f.write("truncat")
    assert not verify_checkpoint_dir(torn)
    assert manager.latest_verified() == good
    assert manager.resolve("latest") == good
    with pytest.raises(CheckpointCorruptError):
        manager.resolve(torn)
    # The step of the torn checkpoint can be saved again; a verified one is never overwritten.
    assert manager.save(1, _write_artifacts(["model.pt"])) == torn and verify_checkpoint_dir(torn)
    with pytest.raises(ValueError, match="already exists"):
        manager.save(1, _write_artifacts(["model.pt"]))


def test_missing_artifact_fails_verification(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    path = manager.save(0, _write_artifacts(["model.pt", "optimizer.pt"]))
    os.unlink(os.path.join(path, "optimizer.pt"))
    assert not verify_checkpoint_dir(path)
    assert manager.latest_verified() is None
    with pytest.raises(FileNotFoundError, match="no verified checkpoint"):
        manager.resolve("latest")


# ------------------------------------------------------------------ data order
def test_seedable_sampler_and_skip_first_batches_follow_jax():
    """The same seed gives JAX's permutation in every epoch; a prepared
    loader over it yields JAX's batches pass after pass, and
    `skip_first_batches` JAX's remaining batches of the pass, which ends
    by advancing the original loader to the next epoch."""
    for epoch in range(3):
        ours, theirs = SeedableRandomSampler(num_samples=32, seed=3), JaxSeedableRandomSampler(num_samples=32, seed=3)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(ours) == list(theirs)
    data = [{"x": np.array([i], np.int64)} for i in range(32)]
    jax_loader = JaxAccelerator().prepare(
        JaxLoader(data, JaxBatchSampler(JaxSeedableRandomSampler(num_samples=32, seed=3), 8)))
    loader = port.Accelerator(cpu=True).prepare(
        port.SimpleDataLoader(data, port.BatchSampler(SeedableRandomSampler(num_samples=32, seed=3), 8)))
    rows = lambda batches: [np.asarray(b["x"]).ravel().tolist() for b in batches]  # noqa: E731
    expect = rows(jax_loader) + rows(jax_loader)
    assert rows(loader) + rows(loader) == expect
    assert expect[:4] != expect[4:]  # the second pass draws another order
    skipped = rows(jax_skip_first_batches(jax_loader, 2))
    assert rows(skip_first_batches(loader, 2)) == skipped and len(skipped) == 2
    assert rows(loader) == rows(jax_loader)  # both advanced past the skipped pass


# ------------------------------------------------------------------ resume
def _loader(data, seed=42):
    return port.SimpleDataLoader(data, port.BatchSampler(SeedableRandomSampler(num_samples=len(data), seed=seed), 8))


def _run(model, project_dir, data, steps_from=0, resume=False, save_after=None):
    """Fused steps over two passes of `data` (shuffled with seed 42) from
    `steps_from`; `resume` restores "latest" first and skips the steps of
    the pass already taken; `save_after` saves after that many steps."""
    accelerator = port.Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(project_dir), automatic_checkpoint_naming=True))
    pm, opt, loader = accelerator.prepare(model, _adamw(model), _loader(data))
    if resume:
        accelerator.load_state("latest")
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    per_pass = len(loader)
    losses = []
    step = steps_from
    while step < 2 * per_pass:
        into = step % per_pass
        for b in accelerator.skip_first_batches(loader, into) if into else loader:
            losses.append(float(step_fn(b)))
            step += 1
            if step == save_after:
                accelerator.save_state()
    return losses, pm, opt


def test_llama_tiny_resumes_bit_for_bit_and_tracks_jax(weights, tmp_path):
    """f32 `llama_tiny`, eight fused steps over two passes of four shuffled
    batches, saved after step 3; a fresh `Accelerator` with a model from
    another seed restores "latest" and runs steps 4-8 from the restored
    loader position: the same losses as the uninterrupted run, bit for bit,
    f32 masters and AdamW state included; the uninterrupted run follows
    JAX's losses on the same shuffled batches."""
    data = _data(32, seed=4)
    full, pm_full, opt_full = _run(_port_model(weights), tmp_path, data, save_after=3)
    assert os.path.basename(CheckpointManager(str(tmp_path / "checkpoints")).resolve()) == "checkpoint_0"

    _reset_port()
    other = port_llama.create_llama_model(weights[2], seed=7, device="cpu")
    resumed, pm, opt = _run(other, tmp_path, data, steps_from=3, resume=True)
    assert resumed == full[3:]
    assert all(torch.equal(a, b) for a, b in zip(pm.parameters(), pm_full.parameters()))
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    state, state_full = opt.state_dict()["state"], opt_full.state_dict()["state"]
    assert all(torch.equal(state[i][k], state_full[i][k]) for i in state for k in state[i])

    _reset_jax()
    accelerator = JaxAccelerator()
    tx = optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)
    _, _, loader = accelerator.prepare(dataclasses.replace(weights[0]), tx, JaxLoader(
        data, JaxBatchSampler(JaxSeedableRandomSampler(num_samples=32, seed=42), 8)))
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    expect = [float(step_fn(b)) for _ in range(2) for b in loader]
    np.testing.assert_allclose(full, expect, **F32_VS_JAX)


class _Counter:
    def __init__(self):
        self.count = 0

    def state_dict(self):
        return {"count": self.count}

    def load_state_dict(self, state):
        self.count = state["count"]


def test_scaler_scheduler_and_registered_objects_survive_a_round_trip(tmp_path):
    """fp16 with a scale that has backed off and a growth tracker mid-way, a
    scheduler two steps in, and a registered counter: `save_state` into a
    directory and `load_state` in a fresh `Accelerator` restore each; the
    learning rate the schedule gives is back in the optimizer. An object
    without `state_dict` cannot be registered."""
    config = port_llama.llama_tiny()
    rows = [{"input_ids": r} for r in np.random.default_rng(0).integers(0, config.vocab_size, (4, 16))]

    def build(seed):
        model = port_llama.create_llama_model(config, seed=seed, device="cpu")
        accelerator = port.Accelerator(mixed_precision="fp16", cpu=True,
                                       kwargs_handlers=[GradScalerKwargs(init_scale=2.0 ** 20, growth_interval=5)])
        counter = _Counter()
        accelerator.register_for_checkpointing(counter)
        parts = accelerator.prepare(model, _adamw(model), port.SimpleDataLoader(rows, port.BatchSampler(range(4), 2)),
                                    lambda step: LR / (1 + step))
        return accelerator, counter, parts

    accelerator, counter, (pm, opt, loader, sched) = build(0)
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    skipped = []
    for _ in range(3):
        for b in loader:
            step_fn(b)
            sched.step()
            skipped.append(opt.step_was_skipped)
            counter.count += 1
    assert any(skipped) and not all(skipped)
    saved = {"scaler": accelerator.scaler.state_dict(), "step": sched.step_count, "lr": opt.learning_rate}
    assert saved["scaler"]["scale"] < 2.0 ** 20 and saved["step"] == skipped.count(False)
    path = accelerator.save_state(str(tmp_path / "ckpt"))
    # No sampler file: the loader's sampler is not seedable.
    assert set(os.listdir(path)) == {"model.pt", "optimizer.pt", "scaler_0.json", "scheduler.pt",
                                     "random_states_0.pt", "custom_checkpoint_0.pkl", CHECKPOINT_MANIFEST_NAME}

    _reset_port()
    accelerator, counter, (pm2, opt2, _, sched2) = build(1)
    assert accelerator.scaler.state_dict() != saved["scaler"]
    accelerator.load_state(path)
    assert accelerator.scaler.state_dict() == saved["scaler"] and opt2.scaler is accelerator.scaler
    assert sched2.step_count == saved["step"] and sched2.get_last_lr() == [saved["lr"]]
    assert opt2.learning_rate == saved["lr"] and counter.count == 6
    assert all(torch.equal(a, b) for a, b in zip(pm.parameters(), pm2.parameters()))
    with pytest.raises(ValueError, match="state_dict"):
        accelerator.register_for_checkpointing(object())
