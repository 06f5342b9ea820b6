"""The port's bundled scripts and test utilities
(`accelerate_tpu_torch/test_utils/`), on the CPU. About 35 s: 17 s for
``accelerate-tpu-torch test --cpu --num_processes 2`` (a spawn of 2 gloo
processes, then the script in a child), 8 s for one spawn of 2 running
`test_ops` and `test_sync`, the rest one process.

  - `test_ops`, `test_sync` and `test_script` pass at one process, and at
    world 2 over gloo (`test_ops` there includes debug mode's shape check
    raising on both processes).
  - The regression fixtures against JAX's on the same seed:
    `RegressionDataset` equal, `RegressionMLPModel`'s initial weights JAX's
    draws (carried with `regression_state_dict_from_flax`), and the same SGD
    training through each package's `Accelerator`: a and b within rtol 1e-5,
    the losses too.
  - `testing.py`: the skips, the singleton reset, the emptied temporary
    directory, the child environment and `execute_subprocess`'s error.
"""

import os
import subprocess
import sys
import unittest

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_dist_workers as workers  # noqa: E402

from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.test_utils import testing, training  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import test_ops, test_script, test_sync  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset_port():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


@pytest.fixture(autouse=True)
def one_process_on_the_cpu(monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_USE_CPU", "1")
    for key in ("ACCELERATE_TPU_MIXED_PRECISION", "ACCELERATE_TPU_GRADIENT_ACCUMULATION_STEPS",
                "ACCELERATE_TPU_DEBUG_MODE"):
        monkeypatch.delenv(key, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _reset_port()
    yield
    _reset_port()
    torch.set_num_threads(threads)


@pytest.mark.parametrize("script,last", [(test_ops, "All op checks passed."),
                                         (test_sync, "All sync checks passed."),
                                         (test_script, "All checks passed.")])
def test_bundled_script_passes_at_one_process(capsys, script, last):
    script.main()
    assert capsys.readouterr().out.strip().splitlines()[-1] == last


def test_cli_test_runs_the_script_at_world_2_and_one_process():
    """``python -m accelerate_tpu_torch.commands.accelerate_cli test --cpu
    --num_processes 2``: the script's 15 checks over 2 gloo processes, then
    at one process, exit 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    env.pop("ACCELERATE_TPU_USE_CPU", None)
    result = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "test", "--cpu",
                             "--num_processes", "2"], capture_output=True, text=True, timeout=300, env=env)
    assert result.returncode == 0, result.stdout + result.stderr
    assert "Multi-process run passed." in result.stdout and "Test is a success!" in result.stdout
    assert result.stdout.count("All checks passed.") == 2
    assert "sync_module_states_check: rank-0 weights win when on" in result.stdout


def test_cli_test_refuses_a_count_that_does_not_divide_8(capsys):
    import argparse

    from accelerate_tpu_torch.commands import test as port_test

    with pytest.raises(SystemExit, match="must divide 8"):
        port_test.test_command(argparse.Namespace(config_file=None, cpu=True, num_processes=3))


def test_ops_and_sync_scripts_at_world_2(tmp_path):
    debug_launcher(workers.scripts2, args=(str(tmp_path),), num_processes=2, timeout=300)
    for rank in range(2):
        lines = (tmp_path / f"rank{rank}.txt").read_text()
        assert "debug_mode ✓" in lines and "All op checks passed." in lines and "All sync checks passed." in lines


# ------------------------------------------------------------------ the fixtures against JAX's
def test_regression_dataset_is_jaxs():
    from accelerate_tpu.test_utils.training import RegressionDataset as JaxDataset

    for seed, length in ((0, 64), (5, 32)):
        port, jax_ds = training.RegressionDataset(length=length, seed=seed), JaxDataset(length=length, seed=seed)
        np.testing.assert_array_equal(port.x, jax_ds.x)
        np.testing.assert_array_equal(port.y, jax_ds.y)
        assert port[3]["y"] == jax_ds[3]["y"] and port[3]["x"].tolist() == jax_ds[3]["x"].tolist()


def _train_jax(model, data, batch_size, steps_lr):
    import optax

    from accelerate_tpu import Accelerator, SimpleDataLoader
    from accelerate_tpu.data_loader import BatchSampler
    from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
    from accelerate_tpu.state import GradientState as JaxGradientState

    JaxAcceleratorState._reset_state()
    JaxGradientState._reset_state()
    accelerator = Accelerator()
    pmodel, popt, pdl = accelerator.prepare(model, optax.sgd(steps_lr),
                                            SimpleDataLoader(data, BatchSampler(range(len(data)), batch_size)))
    losses = []
    for _ in range(3):
        for batch in pdl:
            losses.append(float(accelerator.backward(pmodel.loss, batch)))
            popt.step()
            popt.zero_grad()
    return losses, pmodel.params


def _train_port(model, data, batch_size, lr):
    from accelerate_tpu_torch import Accelerator, BatchSampler, SimpleDataLoader

    _reset_port()
    accelerator = Accelerator()
    pmodel, popt, pdl = accelerator.prepare(model, torch.optim.SGD(model.parameters(), lr=lr),
                                            SimpleDataLoader(data, BatchSampler(range(len(data)), batch_size)))
    losses = []
    for _ in range(3):
        for batch in pdl:
            losses.append(float(accelerator.backward(pmodel.loss, batch)))
            popt.step()
            popt.zero_grad()
    return losses, pmodel.module.state_dict()


def test_regression_training_matches_jax():
    """`RegressionModel` through each package's `Accelerator` with SGD 0.1,
    3 epochs of 4 batches of 16 from seed 5: a and b within rtol 1e-5."""
    from accelerate_tpu.test_utils.training import RegressionModel as JaxModel

    dataset = training.RegressionDataset(length=64, seed=5)
    data = [dataset[i] for i in range(len(dataset))]
    jax_losses, jax_params = _train_jax(JaxModel(), data, 16, 0.1)
    port_losses, port_state = _train_port(training.RegressionModel(), data, 16, 0.1)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    carried = training.regression_state_dict_from_flax(jax_params)
    for name in ("a", "b"):
        np.testing.assert_allclose(port_state[name].numpy(), carried[name].numpy(), rtol=1e-5)
    assert abs(float(port_state["a"][0]) - 2.0) < 0.5 and abs(float(port_state["b"][0]) - 3.0) < 0.5


def test_regression_mlp_starts_at_jaxs_draws_and_trains_alike():
    from accelerate_tpu.test_utils.training import RegressionMLPModel as JaxMLP

    jax_model, port_model = JaxMLP(hidden=16, seed=3), training.RegressionMLPModel(hidden=16, seed=3)
    carried = training.regression_state_dict_from_flax(jax_model.params)
    own = port_model.state_dict()
    assert sorted(carried) == sorted(own)
    for name in own:
        torch.testing.assert_close(own[name], carried[name], rtol=0, atol=0)
    dataset = training.RegressionDataset(length=32, seed=1)
    data = [dataset[i] for i in range(len(dataset))]
    jax_losses, jax_params = _train_jax(jax_model, data, 8, 0.05)
    port_losses, port_state = _train_port(port_model, data, 8, 0.05)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    carried = training.regression_state_dict_from_flax(jax_params)
    for name in port_state:
        np.testing.assert_allclose(port_state[name].numpy(), carried[name].numpy(), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------ testing.py
def test_skips_follow_the_cards_and_the_group(monkeypatch):
    """Each decorator decides when it is applied, from `device_count` and
    the process group (none here)."""
    assert testing.device_count() == (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    for cards, want in ((0, ["test_cuda", "test_multi", "test_process", "test_single"]),
                        (1, ["test_multi", "test_process"]), (2, ["test_process", "test_single"])):
        monkeypatch.setattr(testing, "device_count", lambda cards=cards: cards)

        class Case(unittest.TestCase):
            @testing.require_cuda
            def test_cuda(self):
                pass

            @testing.require_single_device
            def test_single(self):
                pass

            @testing.require_multi_device
            def test_multi(self):
                pass

            @testing.require_multi_process
            def test_process(self):
                pass

        result = unittest.TestResult()
        unittest.defaultTestLoader.loadTestsFromTestCase(Case).run(result)
        assert sorted(test._testMethodName for test, _ in result.skipped) == want


def test_accelerate_test_case_resets_the_singletons():
    class Case(testing.AccelerateTestCase):
        def test_state(self):
            AcceleratorState(cpu=True)
            GradientState()

    unittest.defaultTestLoader.loadTestsFromTestCase(Case).run(unittest.TestResult())
    assert not AcceleratorState._shared_state and not GradientState._shared_state and not PartialState._shared_state


def test_temp_dir_test_case_empties_its_directory_before_each_test():
    seen = []

    class Case(testing.TempDirTestCase):
        def test_a_write(self):
            seen.append(sorted(p.name for p in self.tmpdir.iterdir()))
            (self.tmpdir / "sub").mkdir()
            (self.tmpdir / "sub" / "f.txt").write_text("x")

        def test_b_read(self):
            seen.append(sorted(p.name for p in self.tmpdir.iterdir()))

    result = unittest.TestResult()
    unittest.defaultTestLoader.loadTestsFromTestCase(Case).run(result)
    assert result.wasSuccessful() and seen == [[], []]


def test_cpu_env_and_execute_subprocess():
    env = testing.cpu_env()
    assert env["ACCELERATE_TPU_USE_CPU"] == "1" and env["OMP_NUM_THREADS"] == "1"
    assert env["PYTHONPATH"].split(os.pathsep)[0] == ROOT
    with pytest.raises(RuntimeError, match="exit 3") as failed:
        testing.execute_subprocess([sys.executable, "-c", "print('out'); raise SystemExit(3)"], env=env)
    assert "out" in str(failed.value)
    result = testing.run_test_script("test_ops.py")
    assert "All op checks passed." in result.stdout
