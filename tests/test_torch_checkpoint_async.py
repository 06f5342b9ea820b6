"""Asynchronous and sharded checkpoints of the port
(`accelerate_tpu_torch.checkpointing`: `AsyncCommitter`, `HostStaging`,
`snapshot_accelerator_state`, the ``host_*/`` layout,
`AdaptiveSaveInterval`; the `Accelerator`'s `save_state(async_save=,
sharded=)`, `maybe_save_state`, `drain_checkpoints`,
`poll_async_checkpoint`, `abort_async_checkpoint`) on the CPU, a
counterpart of each test of the JAX package's
`tests/test_checkpoint_async.py`, in its order, with the JAX side run where
a test compares. About 10 s on one torch thread.

The JAX tests inject faults through the chaos package's filesystem
injector; the port has no chaos package yet (ROADMAP A item 6), so these
patch the port's one artifact writer, `checkpointing._save_tensors`, with
the same faults: a slow write, EIO on every try, a kill (a `BaseException`)
inside the second write of ``model.pt``.

Parity with JAX: `AdaptiveSaveInterval`'s intervals equal JAX's exactly for
the same observation sequences; `RegressionMLPModel` (JAX's draws) under
AdamW, saved asynchronously at each of 3 steps and resumed in a fresh
accelerator for 2 more, gives JAX's losses within rtol 1e-5 (the same flow
through JAX's `Accelerator(async_save=True)`); the sharded layout's host
directories, artifact names (JAX's ``X.npz`` with its ``X.manifest.json``
are the port's one ``X.pt``, a `torch.save` that carries its manifest),
``SHARD_DONE``'s JSON and the manifest's ``"sharded"`` block are JAX's for
the same run."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as port
from accelerate_tpu_torch import checkpointing
from accelerate_tpu_torch.checkpointing import (
    AdaptiveSaveInterval,
    AsyncCommitter,
    CheckpointCommitError,
    CheckpointCorruptError,
    CheckpointManager,
    HostStaging,
    is_sharded_checkpoint_dir,
    load_tensors_gathered,
    save_tensor_shards,
    shard_host_dir,
    shard_payload,
    snapshot_accelerator_state,
    snapshot_shards,
    verify_checkpoint_dir,
    write_checkpoint_manifest,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.test_utils.training import RegressionDataset, RegressionMLPModel
from accelerate_tpu_torch.utils import FullyShardedDataParallelPlugin, ProjectConfiguration

LR, WD = 1e-2, 1e-4
HIDDEN, MODEL_SEED = 16, 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset():
    AcceleratorState._reset_state()
    GradientState._reset_state()


@pytest.fixture(autouse=True)
def reset_port_state():
    _reset()
    yield
    _reset()


class _Kill(BaseException):
    """A process dying inside a commit (not an `Exception`)."""


def _data(n=16, seed=0):
    dataset = RegressionDataset(length=n, seed=seed)
    return [dataset[i] for i in range(n)]


def build(base_dir, async_save=False, sharded_save=False, total_limit=None, seed=0, plugin=None, **kwargs):
    """JAX's `build_accelerator`: an accelerator under automatic naming over
    `RegressionMLPModel` (JAX's draws), AdamW and a loader of 2 batches of 8."""
    _reset()
    accelerator = port.Accelerator(
        cpu=True, project_config=ProjectConfiguration(project_dir=str(base_dir), automatic_checkpoint_naming=True,
                                                      total_limit=total_limit),
        async_save=async_save, sharded_save=sharded_save, fsdp_plugin=plugin, **kwargs)
    model = RegressionMLPModel(hidden=HIDDEN, seed=MODEL_SEED + seed)
    optimizer = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    loader = port.SimpleDataLoader(_data(), port.BatchSampler(range(16), 8))
    model, optimizer, loader = accelerator.prepare(model, optimizer, loader)
    return accelerator, model, optimizer, loader


def train_steps(accelerator, model, optimizer, loader, steps, save_each=True):
    stream = (b for _ in iter(int, 1) for b in loader)
    paths, losses = [], []
    for _ in range(steps):
        batch = next(stream)
        losses.append(float(accelerator.backward(model.loss, batch)))
        optimizer.step()
        optimizer.zero_grad()
        if save_each:
            paths.append(accelerator.save_state())
    stream.close()
    return paths, losses


def state_of(model, optimizer):
    """A host copy of the masters and every tensor of the optimizer's state."""
    out = {f"model/{k}": v.detach().clone() for k, v in model.full_state_dict().items()}
    out.update({f"optimizer/{k}": v.detach().clone()
                for k, v in checkpointing.tensor_leaves(optimizer.state_dict()["state"])})
    return out


def file_state(path):
    model = torch.load(os.path.join(path, "model.pt"), weights_only=True)
    optimizer = torch.load(os.path.join(path, "optimizer.pt"), weights_only=True)
    out = {f"model/{k}": v for k, v in model.items()}
    out.update({f"optimizer/{k}": v for k, v in checkpointing.tensor_leaves(optimizer["state"])})
    return out


def assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


# ------------------------------------------------------------------ committer mechanics
def test_committer_serializes_commits_and_surfaces_failure_at_barrier():
    committer = AsyncCommitter()
    order = []
    committer.submit(lambda abort: (time.sleep(0.05), order.append("first")), "first")
    committer.submit(lambda abort: order.append("second"), "second")
    committer.wait()
    assert order == ["first", "second"]

    def fails(abort):
        raise OSError("disk on fire")

    committer.submit(fails, "third")
    with pytest.raises(CheckpointCommitError, match="disk on fire") as info:
        committer.submit(lambda abort: None, "fourth")
    assert isinstance(info.value.__cause__, OSError)
    committer.wait()  # raised once, at the barrier that found it


def test_committer_poll_surfaces_only_process_death_class():
    committer = AsyncCommitter()

    def killed(abort):
        raise _Kill("kill inside the commit")

    committer.submit(killed, "killed")
    time.sleep(0.05)
    with pytest.raises(_Kill):
        committer.poll()

    committer = AsyncCommitter()
    committer.submit(lambda abort: (_ for _ in ()).throw(OSError("eio")), "eio")
    time.sleep(0.05)
    committer.poll()  # an ordinary failure waits for the barrier
    with pytest.raises(CheckpointCommitError):
        committer.wait()


def test_committer_abort_stops_commit_before_publish(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    committer = AsyncCommitter()
    entered, release = threading.Event(), threading.Event()

    def write_fn(staging):
        entered.set()
        release.wait(timeout=5)
        with open(os.path.join(staging, "artifact.bin"), "wb") as f:
            f.write(b"x" * 16)

    committer.submit(lambda abort: manager.save(7, write_fn, abort=abort), "ckpt7")
    assert entered.wait(timeout=5)
    committer._abort.set()
    release.set()
    error = committer.abort_and_join()
    assert isinstance(error, CheckpointCommitError)
    assert manager.checkpoints() == []  # stopped before the publish: staging litter only
    with pytest.raises(CheckpointCommitError):
        committer.submit(lambda abort: None, "after-abort")


# ------------------------------------------------------------------ next_step
def test_next_step_counts_inflight_background_saves(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    started, release = threading.Event(), threading.Event()

    def slow_write(staging):
        started.set()
        release.wait(timeout=5)
        with open(os.path.join(staging, "artifact.bin"), "wb") as f:
            f.write(b"a" * 8)

    worker = threading.Thread(target=lambda: manager.save(0, slow_write))
    worker.start()
    try:
        assert started.wait(timeout=5)
        assert manager.checkpoints() == []
        assert manager.next_step() == 1
        with pytest.raises(ValueError, match="already has a save in flight"):
            manager.save(0, lambda staging: None)
    finally:
        release.set()
        worker.join(timeout=5)
    assert manager.next_step() == 1
    assert [step for step, _ in manager.checkpoints()] == [0]


def test_two_overlapping_accelerator_saves_publish_distinct_steps(tmp_path):
    accelerator, model, opt, loader = build(tmp_path, async_save=True)
    train_steps(accelerator, model, opt, loader, 1, save_each=False)
    first = accelerator.save_state()
    second = accelerator.save_state()  # waits for the first commit
    accelerator.drain_checkpoints()
    assert first != second
    assert verify_checkpoint_dir(first) and verify_checkpoint_dir(second)


# ------------------------------------------------------------------ round trips
@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "sharded"])
def test_async_save_round_trips_through_sync_load(tmp_path, sharded):
    """Async saves at each of 3 steps; a fresh accelerator loads "latest"
    and has the same state bit for bit, which is also what the port's own
    synchronous save of that step writes; its next save does not collide."""
    accelerator, model, opt, loader = build(tmp_path / "async", async_save=True, sharded_save=sharded)
    train_steps(accelerator, model, opt, loader, 3)
    accelerator.drain_checkpoints()
    want = state_of(model, opt)
    sync_path = accelerator.save_state(str(tmp_path / "sync"), async_save=False)

    fresh, model2, opt2, _ = build(tmp_path / "async", seed=1)
    assert not torch.equal(model2.module.dense_in.weight, model.module.dense_in.weight)
    fresh.load_state("latest")
    assert_states_equal(state_of(model2, opt2), want)
    if not sharded:
        assert_states_equal(file_state(accelerator.checkpoint_manager().resolve()), file_state(sync_path))
    assert verify_checkpoint_dir(fresh.save_state())


def _jax_round_trip(base):
    import optax

    from accelerate_tpu import Accelerator, SimpleDataLoader
    from accelerate_tpu.data_loader import BatchSampler
    from accelerate_tpu.state import AcceleratorState as JaxState
    from accelerate_tpu.state import GradientState as JaxGradientState
    from accelerate_tpu.test_utils.training import RegressionMLPModel as JaxMLP
    from accelerate_tpu.utils import ProjectConfiguration as JaxProjectConfiguration

    def jax_build():
        JaxState._reset_state()
        JaxGradientState._reset_state()
        acc = Accelerator(project_config=JaxProjectConfiguration(project_dir=str(base),
                                                                 automatic_checkpoint_naming=True),
                          async_save=True)
        parts = acc.prepare(JaxMLP(hidden=HIDDEN, seed=MODEL_SEED), optax.adamw(LR, weight_decay=WD),
                            SimpleDataLoader(_data(), BatchSampler(range(16), 8)))
        return (acc, *parts)

    acc, model, opt, loader = jax_build()
    _, losses = train_steps(acc, model, opt, loader, 3)
    acc.drain_checkpoints()
    acc, model, opt, loader = jax_build()
    acc.load_state("latest")
    _, more = train_steps(acc, model, opt, loader, 2, save_each=False)
    JaxState._reset_state()
    JaxGradientState._reset_state()
    return losses + more


def test_async_round_trip_losses_track_jax(tmp_path):
    """3 steps saved asynchronously at each, a fresh accelerator resumes from
    "latest" for 2 more: the 5 losses are JAX's (the same flow through JAX's
    `Accelerator(async_save=True)`) within rtol 1e-5."""
    accelerator, model, opt, loader = build(tmp_path / "port", async_save=True)
    _, losses = train_steps(accelerator, model, opt, loader, 3)
    accelerator.drain_checkpoints()
    fresh, model2, opt2, loader2 = build(tmp_path / "port", seed=1)
    fresh.load_state("latest")
    _, more = train_steps(fresh, model2, opt2, loader2, 2, save_each=False)
    np.testing.assert_allclose(losses + more, _jax_round_trip(tmp_path / "jax"), rtol=1e-5)


def _jax_sharded_checkpoint(base):
    import optax

    from accelerate_tpu import Accelerator, SimpleDataLoader
    from accelerate_tpu.data_loader import BatchSampler
    from accelerate_tpu.state import AcceleratorState as JaxState
    from accelerate_tpu.state import GradientState as JaxGradientState
    from accelerate_tpu.test_utils.training import RegressionMLPModel as JaxMLP
    from accelerate_tpu.utils import ProjectConfiguration as JaxProjectConfiguration

    JaxState._reset_state()
    JaxGradientState._reset_state()
    acc = Accelerator(project_config=JaxProjectConfiguration(project_dir=str(base), automatic_checkpoint_naming=True),
                      sharded_save=True)
    model, opt, loader = acc.prepare(JaxMLP(hidden=HIDDEN, seed=MODEL_SEED), optax.adamw(LR, weight_decay=WD),
                                     SimpleDataLoader(_data(), BatchSampler(range(16), 8)))
    train_steps(acc, model, opt, loader, 1)
    path = acc.checkpoint_manager().resolve("latest")
    JaxState._reset_state()
    JaxGradientState._reset_state()
    return path


def _layout(path, artifact):
    """(top-level names, {host dir: sorted names}) with each artifact's name
    mapped by `artifact`."""
    top = sorted(os.listdir(path))
    hosts = {h: sorted({artifact(n) for n in os.listdir(os.path.join(path, h))}) for h in top if h.startswith("host_")}
    return top, hosts


def test_sharded_layout_and_manifest(tmp_path):
    """The layout of one sharded save is JAX's for the same run: host
    directories, artifacts (JAX's ``X.npz`` + ``X.manifest.json`` pair and
    ``.pkl`` are the port's ``X.pt``), ``SHARD_DONE``'s JSON and the
    manifest's ``"sharded"`` block; the directory manifest digests the host
    files, and a torn shard file fails verification."""
    accelerator, model, opt, loader = build(tmp_path / "port", sharded_save=True)
    train_steps(accelerator, model, opt, loader, 1)
    ckpt = accelerator.checkpoint_manager().resolve("latest")
    jax_ckpt = _jax_sharded_checkpoint(tmp_path / "jax")
    assert is_sharded_checkpoint_dir(ckpt) and is_sharded_checkpoint_dir(jax_ckpt)
    jax_name = lambda n: n.replace(".manifest.json", ".pt").replace(".npz", ".pt").replace(".pkl", ".pt")  # noqa: E731
    assert _layout(ckpt, lambda n: n) == _layout(jax_ckpt, jax_name)
    host = os.path.join(ckpt, shard_host_dir(0))
    done = json.load(open(os.path.join(host, "SHARD_DONE")))
    jax_done = json.load(open(os.path.join(jax_ckpt, shard_host_dir(0), "SHARD_DONE")))
    assert done == dict(jax_done, files=[jax_name(n) for n in jax_done["files"]])
    manifest = json.load(open(os.path.join(ckpt, "MANIFEST.json")))
    jax_manifest = json.load(open(os.path.join(jax_ckpt, "MANIFEST.json")))
    assert manifest["sharded"] == jax_manifest["sharded"] == {"num_hosts": 1, "hosts": [shard_host_dir(0)]}
    assert any(rel.startswith(shard_host_dir(0) + os.sep) for rel in manifest["files"])
    assert verify_checkpoint_dir(ckpt)
    target = os.path.join(host, "model.pt")
    with open(target, "r+b") as f:
        f.truncate(os.path.getsize(target) // 2)
    assert not verify_checkpoint_dir(ckpt)


def test_simulated_two_host_checkpoint_gathers_to_parity(tmp_path):
    """Two hosts each write their row slice of `w` and the whole replicated
    `inner/b`: gathered on load, the tree is whole and exact. A host
    missing, or a region no shard covers, raises `CheckpointCorruptError`."""
    gen = torch.Generator().manual_seed(0)
    full = {"w": torch.randn(8, 6, generator=gen), "inner": {"b": torch.randn(4, generator=gen)}}

    def write(base, hosts):
        for host, rows in hosts:
            entries = [("inner/b", full["inner"]["b"], (4,), [[0, 4]]),
                       ("w", full["w"][rows[0]:rows[1]], (8, 6), [[rows[0], rows[1]], [0, 6]])]
            payload = shard_payload(snapshot_shards(entries, lambda p, t: t.clone()),
                                    {"inner": {"b": None}, "w": None}, host)
            save_tensor_shards(payload, base / shard_host_dir(host) / "model.pt")

    write(tmp_path / "two", ((0, (0, 4)), (1, (4, 8))))
    gathered = load_tensors_gathered(tmp_path / "two", "model.pt")
    assert torch.equal(gathered["w"], full["w"]) and torch.equal(gathered["inner"]["b"], full["inner"]["b"])
    write_checkpoint_manifest(tmp_path / "two", step=0, extra=checkpointing.sharded_manifest_extra(2))
    assert verify_checkpoint_dir(tmp_path / "two")

    write(tmp_path / "gap", ((0, (0, 4)), (1, (5, 8))))
    with pytest.raises(CheckpointCorruptError, match="cover 42/48"):
        load_tensors_gathered(tmp_path / "gap", "model.pt")
    write(tmp_path / "lost", ((0, (0, 4)),))
    with pytest.raises(CheckpointCorruptError, match="cover"):
        load_tensors_gathered(tmp_path / "lost", "model.pt")
    with pytest.raises(CheckpointCorruptError, match="of 2"):
        load_tensors_gathered(tmp_path / "lost", "model.pt", num_hosts=2)


def test_snapshot_is_a_true_copy(tmp_path):
    """A commit held open by a gate while training changes the masters and
    moments in place: the checkpoint holds the state of its step bit for
    bit, and none of the state at the drain; the snapshot's buffers are
    the staging's, kept for the next save."""
    accelerator, model, opt, loader = build(tmp_path, async_save=True)
    train_steps(accelerator, model, opt, loader, 2, save_each=False)
    want = state_of(model, opt)
    gate, entered = threading.Event(), threading.Event()
    write = checkpointing.write_accelerator_snapshot

    def gated(*args, **kwargs):
        entered.set()
        assert gate.wait(timeout=10)
        return write(*args, **kwargs)

    checkpointing.write_accelerator_snapshot = gated
    try:
        path = accelerator.save_state()
        assert entered.wait(timeout=10)
        pointers = {p.data_ptr() for p in model.module.parameters()}
        train_steps(accelerator, model, opt, loader, 2, save_each=False)  # in place, during the commit
        assert {p.data_ptr() for p in model.module.parameters()} == pointers
        assert accelerator.telemetry.value("checkpoint_commits_in_flight") == 1
        gate.set()
        accelerator.drain_checkpoints()
    finally:
        checkpointing.write_accelerator_snapshot = write
    live = state_of(model, opt)
    written = file_state(path)
    assert_states_equal(written, want)
    assert not any(torch.equal(written[k], live[k]) for k in written if k.startswith("model/"))
    staging = accelerator._host_staging
    assert staging.nbytes >= sum(t.numel() * t.element_size() for t in want.values())  # and the RNG streams
    setup = staging.setup_s
    accelerator.save_state()
    accelerator.drain_checkpoints()
    assert staging.setup_s == setup  # the second save made no buffer


def test_staging_copies_are_not_the_sources():
    staging = HostStaging()
    source = {"a": torch.arange(8.0), "inner": {"b": torch.arange(4, dtype=torch.int32)}}
    copy = checkpointing._HostCopy(staging).tree("t", source)
    source["a"].add_(1)
    source["inner"]["b"][0] = 99
    assert torch.equal(copy["a"], torch.arange(8.0)) and int(copy["inner"]["b"][0]) == 0
    assert copy["a"] is staging.take("t/a", copy["a"], pin=False)


# ------------------------------------------------------------------ goodput
def _slow_model_writes(monkeypatch, delay):
    save = checkpointing._save_tensors

    def slow(path, obj):
        if str(path).endswith("model.pt"):
            time.sleep(delay)
        return save(path, obj)

    monkeypatch.setattr(checkpointing, "_save_tensors", slow)


def test_async_save_charges_only_blocking_time(tmp_path, monkeypatch):
    """A 0.4 s stall in the model file's write: a synchronous save charges
    it to the ledger's "checkpoint" cause; an asynchronous one charges only
    its blocking part, and the stall shows in
    `checkpoint_async_commit_seconds`."""
    delay = 0.4
    _slow_model_writes(monkeypatch, delay)
    results = {}
    for mode in ("sync", "async"):
        accelerator, model, opt, loader = build(tmp_path / mode, async_save=(mode == "async"))
        train_steps(accelerator, model, opt, loader, 1)
        accelerator.drain_checkpoints()
        results[mode] = {"lost": accelerator.timeline.goodput()["lost_s"].get("checkpoint", 0.0),
                         "commit_s": accelerator._m_ckpt_commit_seconds.sum,
                         "commits": accelerator._m_ckpt_commit_seconds.count,
                         "blocking": accelerator._m_ckpt_seconds.sum}
    assert results["sync"]["lost"] >= 0.9 * delay and results["sync"]["commits"] == 0
    assert results["async"]["lost"] <= 0.5 * delay and results["async"]["commits"] == 1
    assert results["async"]["lost"] == pytest.approx(results["async"]["blocking"], abs=1e-5)  # the ledger rounds to a microsecond
    assert results["async"]["commit_s"] >= 0.9 * delay


# ------------------------------------------------------------------ failures
def test_failed_async_commit_surfaces_on_next_save(tmp_path, monkeypatch):
    def eio(path, obj):
        if str(path).endswith("model.pt"):
            raise OSError(5, "Input/output error")
        return save(path, obj)

    save = checkpointing._save_tensors
    monkeypatch.setattr(checkpointing, "_save_tensors", eio)
    accelerator, model, opt, loader = build(tmp_path, async_save=True)
    train_steps(accelerator, model, opt, loader, 1)
    time.sleep(0.05)
    with pytest.raises(CheckpointCommitError):
        train_steps(accelerator, model, opt, loader, 1)
    assert accelerator.checkpoint_manager().checkpoints() == []


def test_kill_mid_background_commit_keeps_previous_checkpoint_loadable(tmp_path, monkeypatch):
    """The second commit dies inside its model file's write (a kill):
    `poll_async_checkpoint` raises it, the dying run aborts its committer,
    and checkpoint_0 stays the verified, loadable latest."""
    save = checkpointing._save_tensors
    calls = []

    def killing(path, obj):
        if str(path).endswith("model.pt"):
            calls.append(path)
            if len(calls) == 2:
                raise _Kill("killed inside the write")
        return save(path, obj)

    monkeypatch.setattr(checkpointing, "_save_tensors", killing)
    accelerator, model, opt, loader = build(tmp_path, async_save=True)
    states = []
    for _ in range(2):
        train_steps(accelerator, model, opt, loader, 1, save_each=False)
        states.append(state_of(model, opt))
        accelerator.save_state()
    with pytest.raises(_Kill):
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            accelerator.poll_async_checkpoint()
            time.sleep(0.01)
    assert accelerator.abort_async_checkpoint() is None
    resolved = accelerator.checkpoint_manager().resolve("latest")
    assert resolved.endswith("checkpoint_0") and verify_checkpoint_dir(resolved)
    fresh, model2, opt2, _ = build(tmp_path, seed=1)
    fresh.load_state("latest")
    assert_states_equal(state_of(model2, opt2), states[0])


def test_preemption_flushes_inflight_commit(tmp_path):
    import signal

    accelerator, model, opt, loader = build(tmp_path, async_save=True)
    handler = accelerator.register_preemption_checkpoint(exit_on_save=False)
    try:
        train_steps(accelerator, model, opt, loader, 1)
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.preemption_requested
        assert accelerator.check_preemption() is True
    finally:
        handler.uninstall()
    manager = accelerator.checkpoint_manager()
    assert [step for step, path in manager.checkpoints() if verify_checkpoint_dir(path)] == [0, 1]


# ------------------------------------------------------------------ the launcher's variables
def test_launch_exports_async_and_sharded_save_env(monkeypatch):
    """The port's launcher writes JAX's variables for the flags and the
    config keys, and an `Accelerator()` reads them."""
    import argparse

    from accelerate_tpu.commands.launch import add_launch_args as jax_args
    from accelerate_tpu.commands.launch import build_launch_env as jax_env
    from accelerate_tpu_torch.commands.launch import add_launch_args, build_launch_env

    keys = ("ACCELERATE_TPU_ASYNC_SAVE", "ACCELERATE_TPU_SHARDED_SAVE")
    for key in keys:
        monkeypatch.delenv(key, raising=False)
    for argv, config in ((["--async_save", "--sharded_save"], {}), ([], {"async_save": True}),
                         ([], {"sharded_save": True})):
        envs = []
        for add, env_of in ((add_launch_args, build_launch_env), (jax_args, jax_env)):
            parser = argparse.ArgumentParser()
            add(parser)
            env = env_of(parser.parse_args([*argv, "script.py"]), config)
            envs.append({k: env.get(k) for k in keys})
        assert envs[0] == envs[1] and any(envs[0].values())
    for key in keys:
        monkeypatch.setenv(key, "1")
    accelerator = port.Accelerator(cpu=True)
    assert accelerator.async_save and accelerator.sharded_save
    assert not port.Accelerator(cpu=True, async_save=False, sharded_save=False).async_save


# ------------------------------------------------------------------ the cadence
def _both(**kw):
    from accelerate_tpu.checkpointing import AdaptiveSaveInterval as JaxAdaptiveSaveInterval

    return AdaptiveSaveInterval(**kw), JaxAdaptiveSaveInterval(**kw)


def _feed(pair, steps=(), saves=()):
    """Feed both controllers the same observations; after each, their
    intervals are equal."""
    for kind, values in (("observe_step", steps), ("observe_save", saves)):
        for value in values:
            for ctl in pair:
                getattr(ctl, kind)(value)
            assert pair[0].interval == pair[1].interval
            assert pair[0].describe() == pair[1].describe()
    return pair[0].interval


class TestAdaptiveSaveInterval:
    """JAX's controller and the port's, fed the same sequences: the same
    interval after every observation, and the values JAX's tests pin."""

    def test_no_cadence_before_first_step_observation(self):
        ours, theirs = _both(lost_checkpoint_s=10.0)
        assert ours.interval is None and theirs.interval is None
        assert not ours.should_save(10_000) and not theirs.should_save(10_000)

    def test_budget_cap_from_step_observations(self):
        pair = _both(lost_checkpoint_s=10.0, overhead_fraction=0.1)
        assert _feed(pair, steps=[0.1] * 20) == 100
        assert pair[0].should_save(100) and not pair[0].should_save(99)
        assert _feed(pair, saves=[0.5]) == 100

    def test_smaller_budget_saves_more_often_and_slower_steps_too(self):
        a, b, c = _both(lost_checkpoint_s=10.0), _both(lost_checkpoint_s=2.0), _both(lost_checkpoint_s=10.0)
        ia, ib, ic = _feed(a, steps=[0.1] * 5), _feed(b, steps=[0.1] * 5), _feed(c, steps=[0.4] * 5)
        assert ib < ia and ic < ia

    def test_expensive_saves_stretch_past_an_unaffordable_budget(self):
        pair = _both(lost_checkpoint_s=10.0, overhead_fraction=0.1)
        _feed(pair, steps=[0.1] * 10)
        assert _feed(pair, saves=[5.0] * 30) == 500

    def test_fixed_interval_mode_and_validation(self):
        pair = _both(fixed_interval=7)
        assert _feed(pair, steps=[0.3, 0.1], saves=[2.0]) == 7
        assert pair[0].should_save(7) and not pair[0].should_save(6)
        for bad in (dict(lost_checkpoint_s=0.0), dict(overhead_fraction=1.5), dict(fixed_interval=0),
                    dict(min_interval=3, max_interval=2), dict(ema=0.0)):
            with pytest.raises(ValueError):
                AdaptiveSaveInterval(**bad)

    def test_ema_tracks_drifting_step_time(self):
        pair = _both(lost_checkpoint_s=10.0, ema=0.5)
        fast = _feed(pair, steps=[0.1] * 10)
        assert _feed(pair, steps=[1.0] * 10) < fast
        rng = np.random.default_rng(0)
        _feed(pair, steps=rng.uniform(0.01, 2.0, 40).tolist(), saves=rng.uniform(0.0, 30.0, 20).tolist())


def test_accelerator_auto_save_interval_drives_maybe_save_state(tmp_path):
    acc = port.Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True), save_interval="auto", lost_checkpoint_s=0.001)
    model = RegressionMLPModel(hidden=HIDDEN, seed=MODEL_SEED)
    model, opt, loader = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD),
                                     port.SimpleDataLoader(_data(8), port.BatchSampler(range(8), 4)))
    saved = []
    for _ in range(3):
        for batch in loader:
            acc.backward(model.loss, batch)
            opt.step()
            opt.zero_grad()
        path = acc.maybe_save_state()
        if path:
            saved.append(path)
    ctl = acc.save_controller
    assert saved and ctl.saves_observed == len(saved)
    assert ctl.avg_save_s is not None and ctl.avg_save_s > 0
    assert ctl.steps_observed >= 2
    assert os.path.isdir(saved[0])


def test_accelerator_fixed_save_interval(tmp_path):
    acc = port.Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True), save_interval=2)
    model = RegressionMLPModel(hidden=HIDDEN, seed=MODEL_SEED)
    model, opt, loader = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD),
                                     port.SimpleDataLoader(_data(8), port.BatchSampler(range(8), 4)))
    saves = 0
    for _ in range(6):
        for batch in loader:
            acc.backward(model.loss, batch)
            opt.step()
            opt.zero_grad()
        if acc.maybe_save_state():
            saves += 1
    assert saves == 3
    _reset()
    plain = port.Accelerator(cpu=True, project_config=ProjectConfiguration(project_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="save_interval"):
        plain.maybe_save_state()


# ------------------------------------------------------------------ the offload tiers
@pytest.mark.parametrize("tier", ["pinned_host", "disk"])
def test_async_save_copies_out_of_the_offload_tiers(tmp_path, tier):
    """Under `offload_optimizer_state=True` the moments are views of one
    host arena, on the disk tier they live in the store; an async save's
    commit, held open while training rewrites both in place, still holds
    the state of its step, and a fresh accelerator on the same tier loads
    it bit for bit."""
    kwargs = ({"offload_optimizer_state": True} if tier == "pinned_host"
              else {"offload_optimizer_device": "disk", "offload_dir": str(tmp_path / "store")})
    plugin = FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD", **kwargs)
    accelerator, model, opt, loader = build(tmp_path / "run", async_save=True, plugin=plugin)
    assert opt.offload is not None and opt.offload.tier == tier
    train_steps(accelerator, model, opt, loader, 2, save_each=False)
    want = state_of(model, opt)
    gate = threading.Event()
    write = checkpointing.write_accelerator_snapshot

    def gated(*args, **kw):
        assert gate.wait(timeout=10)
        return write(*args, **kw)

    checkpointing.write_accelerator_snapshot = gated
    try:
        path = accelerator.save_state()
        train_steps(accelerator, model, opt, loader, 2, save_each=False)
        gate.set()
        accelerator.drain_checkpoints()
    finally:
        checkpointing.write_accelerator_snapshot = write
    assert_states_equal(file_state(path), want)
    fresh_plugin = FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD", **(
        kwargs if tier == "pinned_host" else dict(kwargs, offload_dir=str(tmp_path / "store2"))))
    fresh, model2, opt2, _ = build(tmp_path / "run", seed=1, plugin=fresh_plugin)
    fresh.load_state(path)
    assert_states_equal(state_of(model2, opt2), want)


def test_snapshot_accelerator_state_without_staging_keeps_host_tensors(tmp_path):
    """A snapshot written at once (a synchronous sharded save) takes host
    tensors as they are, cut to their own bytes: a view into a larger
    tensor is not written with the rest of its storage."""
    accelerator, model, opt, loader = build(tmp_path)
    train_steps(accelerator, model, opt, loader, 1, save_each=False)
    snapshot = snapshot_accelerator_state(accelerator._models, accelerator._optimizers, [], [], sharded=True)
    entries, skeleton = snapshot["host_files"]["model.pt"]
    assert set(skeleton) == set(model.module.state_dict())
    for entry in entries:
        (bounds, tensor), = entry["shards"]
        assert bounds == [[0, d] for d in entry["global_shape"]]
        assert tensor.untyped_storage().nbytes() == tensor.numel() * tensor.element_size()
    view = torch.arange(12.0).view(3, 4)[:, 1:3]
    assert checkpointing._HostCopy(None)("v", view).untyped_storage().nbytes() == 6 * 4


def test_checkpoint_files_leave_out_the_zip_crc_and_put_the_setting_back(tmp_path):
    """A checkpoint's tensors are written without `torch.save`'s per-record
    zip CRC32 (the directory's SHA-256 manifest is its integrity check;
    `torch.load` never reads the CRC), also when saves overlap on two
    threads, and torch's setting (kept per thread) is what it was after."""
    import zipfile

    before = torch.serialization.get_crc32_options()
    payload = {"x": torch.arange(4096.0)}
    threads = [threading.Thread(target=checkpointing._save_tensors, args=(tmp_path / f"{i}.pt", payload))
               for i in range(2)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert torch.serialization.get_crc32_options() == before
    for i in range(2):
        records = zipfile.ZipFile(tmp_path / f"{i}.pt").infolist()
        assert [r.CRC for r in records if r.filename.endswith("/data/0")] == [0]
        assert torch.equal(torch.load(tmp_path / f"{i}.pt", weights_only=True)["x"], payload["x"])
