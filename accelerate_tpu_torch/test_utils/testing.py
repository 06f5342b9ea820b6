"""Test harness (the port of `accelerate_tpu/test_utils/testing.py`).

Singleton hygiene: `AccelerateTestCase` resets the port's state singletons
after each test. Capability skips: `require_cuda` (in `require_tpu`'s
place), `require_single_device`, `require_multi_device` (cards) and
`require_multi_process` (a process group larger than one). `cpu_env` is
the environment of a child on the CPU (in `cpu_mesh_env`'s place: one
process a rank here, so no device count): ``ACCELERATE_TPU_USE_CPU=1``, one
thread, and the package on ``PYTHONPATH``. `run_test_script` runs one of the
bundled `scripts/` in such a child."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import unittest
from pathlib import Path


def device_count() -> int:
    """The cards this process sees (0 without CUDA)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def skip(reason: str):
    return unittest.skip(reason)


def require_cuda(test_case):
    return unittest.skipUnless(device_count() > 0, "test requires a CUDA device")(test_case)


def require_single_device(test_case):
    return unittest.skipUnless(device_count() == 1, "test requires exactly one CUDA device")(test_case)


def require_multi_device(test_case):
    return unittest.skipUnless(device_count() > 1, "test requires more than one CUDA device")(test_case)


def require_multi_process(test_case):
    import torch.distributed as dist

    several = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    return unittest.skipUnless(several, "test requires a process group of more than one process")(test_case)


class AccelerateTestCase(unittest.TestCase):
    """Resets the state singletons in tearDown, so that no test leaks its
    topology or precision into the next."""

    def tearDown(self):
        super().tearDown()
        from ..state import AcceleratorState, GradientState, PartialState

        AcceleratorState._reset_state()
        GradientState._reset_state()
        PartialState._reset_state()


class TempDirTestCase(AccelerateTestCase):
    """Provides `self.tmpdir`, emptied before each test."""

    clear_on_setup = True

    @classmethod
    def setUpClass(cls):
        super().setUpClass()
        cls._tmpdir_obj = tempfile.TemporaryDirectory()
        cls.tmpdir = Path(cls._tmpdir_obj.name)

    @classmethod
    def tearDownClass(cls):
        super().tearDownClass()
        cls._tmpdir_obj.cleanup()

    def setUp(self):
        super().setUp()
        if self.clear_on_setup:
            for path in sorted(self.tmpdir.glob("**/*"), reverse=True):
                if path.is_file():
                    path.unlink()
                elif path.is_dir() and not any(path.iterdir()):
                    path.rmdir()


def execute_subprocess(cmd, env=None, timeout: int = 600) -> subprocess.CompletedProcess:
    """Run a command, raising with its captured output when it fails."""
    result = subprocess.run(cmd, env=env if env is not None else os.environ.copy(), capture_output=True, text=True,
                            timeout=timeout)
    if result.returncode != 0:
        raise RuntimeError(
            f"Command {cmd} failed (exit {result.returncode})\n"
            f"--- stdout ---\n{result.stdout}\n--- stderr ---\n{result.stderr}"
        )
    return result


def cpu_env() -> dict:
    """The environment of a child that runs the port on the CPU: this one
    with ``ACCELERATE_TPU_USE_CPU=1``, one torch thread, and the package's
    parent directory on ``PYTHONPATH`` (a source checkout works too)."""
    env = os.environ.copy()
    env["ACCELERATE_TPU_USE_CPU"] = "1"
    env["OMP_NUM_THREADS"] = "1"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def run_test_script(script_name: str, extra_args=(), env=None, timeout: int = 600) -> subprocess.CompletedProcess:
    """Run one of the bundled `test_utils/scripts/` by name, by default on
    the CPU (`cpu_env`)."""
    from . import scripts

    script = os.path.join(os.path.dirname(scripts.__file__), script_name)
    return execute_subprocess([sys.executable, script, *extra_args], env=env if env is not None else cpu_env(),
                              timeout=timeout)
