"""Preemption in the port (`fault_tolerance.PreemptionHandler`,
`Accelerator.register_preemption_checkpoint`, `preemption_requested`,
`check_preemption`) on the CPU, held to the JAX package's handler and its
`check_preemption`. About 20 s, most of it two fresh interpreters.

  - The latch: SIGTERM (and SIGINT when asked) sets it, as in JAX; off the
    main thread it warns and never sets (`installed` False), as JAX's does.
  - `check_preemption` in a subprocess saves into the registered base and
    exits 143, and the checkpoint loads back bit for bit; under
    ``exit_on_save=False`` it returns True; without a signal, False.
  - It drains an asynchronous commit held open before its own save.
  - ``launch --max_restarts 1`` takes exit 143 as final: one attempt.
"""

import logging
import os
import signal
import subprocess
import sys
import textwrap
import threading

import pytest
import torch

import accelerate_tpu_torch as port
from accelerate_tpu_torch import checkpointing
from accelerate_tpu_torch.checkpointing import CheckpointManager, verify_checkpoint_dir
from accelerate_tpu_torch.fault_tolerance import PREEMPTED_EXIT_CODE, PreemptionHandler
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.test_utils.training import RegressionDataset, RegressionMLPModel
from accelerate_tpu_torch.utils import ProjectConfiguration

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def reset_port_state():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("catch_sigint", [False, True])
def test_the_latch_follows_jax(catch_sigint):
    """Each package's handler, installed in turn: the signal sets the latch
    (SIGINT only when asked), `reset` clears it, `uninstall` puts the
    previous handlers back."""
    from accelerate_tpu.fault_tolerance import PreemptionHandler as JaxPreemptionHandler

    before = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    seen = {}
    for name, cls in (("port", PreemptionHandler), ("jax", JaxPreemptionHandler)):
        called = []
        handler = cls(catch_sigint=catch_sigint, on_preempt=lambda: called.append(1))
        try:
            assert handler.installed and not handler.preemption_requested
            os.kill(os.getpid(), signal.SIGTERM)
            after_term = handler.preemption_requested
            handler.reset()
            cleared = handler.preemption_requested
            if catch_sigint:
                os.kill(os.getpid(), signal.SIGINT)
            after_int = handler.preemption_requested
        finally:
            handler.uninstall()
        seen[name] = (after_term, cleared, after_int, len(called))
        assert {sig: signal.getsignal(sig) for sig in before} == before
    assert seen["port"] == seen["jax"] == (True, False, catch_sigint, 1 + catch_sigint)


def test_off_the_main_thread_the_latch_is_a_no_op(caplog):
    from accelerate_tpu.fault_tolerance import PreemptionHandler as JaxPreemptionHandler

    made = {}

    def build():
        made["port"], made["jax"] = PreemptionHandler(), JaxPreemptionHandler()

    with caplog.at_level(logging.WARNING):
        thread = threading.Thread(target=build)
        thread.start()
        thread.join()
    assert not made["port"].installed and not made["jax"].installed
    assert not made["port"].preemption_requested
    assert "off the main thread" in caplog.text
    made["port"].uninstall()  # a no-op


def _build(base, **kwargs):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    accelerator = port.Accelerator(cpu=True, **kwargs)
    model = RegressionMLPModel(hidden=8, seed=1)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)
    dataset = RegressionDataset(length=8, seed=0)
    loader = port.SimpleDataLoader([dataset[i] for i in range(8)], port.BatchSampler(range(8), 4))
    return (accelerator, *accelerator.prepare(model, optimizer, loader))


def test_check_preemption_without_a_signal_returns_false(tmp_path):
    accelerator, *_ = _build(tmp_path)
    assert accelerator.check_preemption() is False  # nothing registered
    handler = accelerator.register_preemption_checkpoint(str(tmp_path / "pre"))
    try:
        assert not accelerator.preemption_requested and accelerator.check_preemption() is False
    finally:
        handler.uninstall()
    assert not os.path.exists(tmp_path / "pre")


PREEMPTED = textwrap.dedent('''
    import os, signal, sys, json
    import torch
    import accelerate_tpu_torch as port
    from accelerate_tpu_torch.test_utils.training import RegressionDataset, RegressionMLPModel

    base = sys.argv[1]
    accelerator = port.Accelerator(cpu=True)
    model = RegressionMLPModel(hidden=8, seed=1)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)
    dataset = RegressionDataset(length=8, seed=0)
    loader = port.SimpleDataLoader([dataset[i] for i in range(8)], port.BatchSampler(range(8), 4))
    model, optimizer, loader = accelerator.prepare(model, optimizer, loader)
    accelerator.register_preemption_checkpoint(base)
    for batch in loader:
        accelerator.backward(model.loss, batch)
        optimizer.step()
        optimizer.zero_grad()
    torch.save({k: v.clone() for k, v in model.module.state_dict().items()}, os.path.join(sys.argv[2], "weights.pt"))
    with open(os.path.join(sys.argv[2], "attempts.txt"), "a") as f:
        f.write("attempt\\n")
    os.kill(os.getpid(), signal.SIGTERM)
    accelerator.check_preemption()
    print("not reached")
''')


def _write_script(tmp_path):
    script = tmp_path / "preempted.py"
    script.write_text(PREEMPTED)
    return script


def test_check_preemption_saves_and_exits_143_in_a_subprocess(tmp_path):
    """SIGTERM, then `check_preemption()` at the step boundary: the process
    exits 143 with a verified checkpoint under the registered base (a
    `CheckpointManager` base, as JAX's), which loads back bit for bit."""
    script = _write_script(tmp_path)
    base = tmp_path / "preempt"
    run = subprocess.run([sys.executable, str(script), str(base), str(tmp_path)], capture_output=True, text=True,
                         timeout=300, env=_env())
    assert run.returncode == PREEMPTED_EXIT_CODE == 143, run.stderr[-2000:]
    assert "not reached" not in run.stdout and "preemption checkpoint saved to" in run.stdout
    path = CheckpointManager(str(base)).resolve("latest")
    assert os.path.basename(path) == "checkpoint_0" and verify_checkpoint_dir(path)
    accelerator, model, _, _ = _build(tmp_path)
    accelerator.load_state(str(base))
    saved = torch.load(tmp_path / "weights.pt", weights_only=True)
    assert all(torch.equal(model.module.state_dict()[k], v) for k, v in saved.items())


def test_check_preemption_drains_the_commit_in_flight_first(tmp_path):
    """An async save whose commit is held open: `check_preemption()` waits
    for it (it publishes first) before its own synchronous save, and
    returns True under ``exit_on_save=False``; the preemption's save is a
    synchronous one (no second commit)."""
    accelerator, model, optimizer, loader = _build(tmp_path, async_save=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True))
    handler = accelerator.register_preemption_checkpoint(exit_on_save=False)
    gate, order = threading.Event(), []
    write = checkpointing.write_accelerator_snapshot

    def gated(snapshot, output_dir, *args, **kwargs):
        assert gate.wait(timeout=10)
        order.append("commit")
        return write(snapshot, output_dir, *args, **kwargs)

    checkpointing.write_accelerator_snapshot = gated
    try:
        for batch in loader:
            accelerator.backward(model.loss, batch)
            optimizer.step()
            optimizer.zero_grad()
        inflight = accelerator.save_state()
        os.kill(os.getpid(), signal.SIGTERM)
        threading.Timer(0.2, gate.set).start()
        assert accelerator.check_preemption() is True
        order.append("preemption")
    finally:
        checkpointing.write_accelerator_snapshot = write
        gate.set()
        handler.uninstall()
    assert order == ["commit", "preemption"]
    manager = accelerator.checkpoint_manager()
    assert [os.path.basename(p) for _, p in manager.checkpoints()] == ["checkpoint_0", "checkpoint_1"]
    assert os.path.basename(inflight) == "checkpoint_0"
    assert all(verify_checkpoint_dir(p) for _, p in manager.checkpoints())
    assert accelerator._m_ckpt_commit_seconds.count == 1


def test_launch_with_restarts_takes_143_as_final(tmp_path):
    """``launch --cpu --max_restarts 1``: the preempted child exits 143 and
    the supervisor does not restart it (JAX's rule)."""
    script = _write_script(tmp_path)
    base = tmp_path / "preempt"
    run = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch", "--cpu",
                          "--max_restarts", "1", str(script), str(base), str(tmp_path)],
                         capture_output=True, text=True, timeout=300, env=_env())
    assert run.returncode == 143, run.stderr[-2000:]
    assert (tmp_path / "attempts.txt").read_text().splitlines() == ["attempt"]
    assert verify_checkpoint_dir(CheckpointManager(str(base)).resolve("latest"))
