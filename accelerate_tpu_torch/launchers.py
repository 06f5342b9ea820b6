"""Launching several processes (the port of `accelerate_tpu/launchers.py`'s
`debug_launcher`).

`debug_launcher(function, args, num_processes)` runs ``function(*args)`` in
`num_processes` fresh CPU processes joined over gloo on a free localhost
port: each child gets the variables torchrun would set (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
``ACCELERATE_TPU_USE_CPU=1``, so the first `PartialState` it builds joins
the group. `function` must be importable by name (a module-level function):
the children are spawned, not forked. `notebook_launcher` and the launch
CLI wait for ROADMAP A item 2.
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional

THREADS = 1  # torch threads a child runs
GRACE_S = 10.0  # how long the other children may run on after one failed


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _debug_worker(index: int, function, args, env: dict, error_dir: str):
    """A child: the launcher's variables first, then `function`; a failure
    leaves its traceback in ``rank<index>.err`` and exits 1."""
    os.environ.update(env)
    os.environ["RANK"] = os.environ["LOCAL_RANK"] = str(index)
    try:
        import torch

        torch.set_num_threads(THREADS)
        function(*args)
    except BaseException:
        with open(os.path.join(error_dir, f"rank{index}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def debug_launcher(function: Callable, args=(), num_processes: int = 2, timeout: Optional[float] = None):
    """Run ``function(*args)`` in `num_processes` CPU processes over gloo and
    wait for all of them. Each child runs torch on one thread (the test
    suite runs several workers already). When a child fails, the others get
    `GRACE_S` seconds to finish (a collective they wait in would never
    return) and are then terminated; the error names every child that
    failed, with its traceback. `timeout` bounds the whole run."""
    import multiprocessing

    env = {
        "WORLD_SIZE": str(num_processes),
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(free_port()),
        "ACCELERATE_TPU_USE_CPU": "1",
        "ACCELERATE_TPU_DEBUG_LAUNCHER": "1",
        "OMP_NUM_THREADS": str(THREADS),
    }
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as error_dir:
        procs = [ctx.Process(target=_debug_worker, args=(i, function, args, env, error_dir))
                 for i in range(num_processes)]
        for p in procs:
            p.start()
        start, failed_at = time.monotonic(), None
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            if (failed_at is not None and now - failed_at > GRACE_S) or (timeout is not None and now - start > timeout):
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                break
            time.sleep(0.05)
        for p in procs:
            p.join()
        failed = [i for i, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            msgs = []
            for i in failed:
                err_file = os.path.join(error_dir, f"rank{i}.err")
                if os.path.exists(err_file):
                    with open(err_file) as f:
                        msgs.append(f"-- process {i} --\n{f.read()}")
                else:
                    msgs.append(f"-- process {i} -- exited with code {procs[i].exitcode}")
            raise RuntimeError(f"debug_launcher: {len(failed)}/{num_processes} processes failed:\n" + "\n".join(msgs))
