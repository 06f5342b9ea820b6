"""Launching several processes (the port of `accelerate_tpu/launchers.py`).

`debug_launcher(function, args, num_processes)` runs ``function(*args)`` in
`num_processes` fresh CPU processes joined over gloo on a localhost port:
each child gets the variables torchrun would set (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
``ACCELERATE_TPU_USE_CPU=1``, so the first `PartialState` it builds joins
the group. The launcher hosts the group's rendezvous store itself
(`hosted_store`, torchrun's agent store): its port is bound from the moment
it is picked, so no other process can take it before the ranks meet.
`function` must be importable by name (a module-level function): the
children are spawned, not forked.

`notebook_launcher` is JAX's: it refuses to run after a state exists, sets
``ACCELERATE_TPU_MIXED_PRECISION``, and runs the function in this process
on the card. JAX drives every local chip from one process; the port's form
of "every local device" is one process per card over NCCL, so
``num_processes > 1`` spawns that many (no more than there are cards).
Without a card (or under ``ACCELERATE_TPU_USE_CPU``) ``num_processes > 1``
goes to `debug_launcher`, as JAX's does on the CPU.

`LocalProcesses` is the launch command's group of children: N copies of a
command, each with its rank's variables, waited on together; when one
fails, the others get `GRACE_S` seconds and are then terminated, and the
group's exit code is the first failure's.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional

THREADS = 1  # torch threads a CPU child runs
GRACE_S = 10.0  # how long the other children may run on after one failed
POLL_S = 0.05


def hosted_store(addr: str = "127.0.0.1"):
    """(store, variables): a TCP store this process hosts, on a port the OS
    picks as it binds, and the variables that send a group's ranks to it at
    `addr` (``MASTER_ADDR``, ``MASTER_PORT`` and torch's
    ``TORCHELASTIC_USE_AGENT_STORE``, under which every rank's ``env://``
    rendezvous is a client, as under torchrun's agent). A port found free
    and bound later by rank 0 can be taken in between by any process of
    the host (another group's gloo pairs open ports by the dozen); this one
    is held from the pick until the store is dropped. Keep the store while
    the group runs."""
    from torch.distributed import TCPStore

    store = TCPStore(addr, 0, is_master=True, wait_for_workers=False)
    return store, {"MASTER_ADDR": addr, "MASTER_PORT": str(store.port), "TORCHELASTIC_USE_AGENT_STORE": "True"}


def rank_env(env: dict, rank: int, num_processes: int, port: int) -> dict:
    """`env` with torch's variables for rank `rank` of a group of
    `num_processes` on this host (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` 127.0.0.1, ``MASTER_PORT``), which `PartialState` reads."""
    return {**env, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(num_processes),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


class LocalProcesses:
    """`num_processes` children of `cmd` on this host, one a rank, joined at
    a store this process hosts for the group (`hosted_store`); shaped like a
    `subprocess.Popen` (`pid`, `poll`, `wait`, `send_signal`, `kill`) so
    that the `Supervisor` restarts the whole group as one unit, on a store
    of its own, as torchrun's agent restarts a worker group."""

    def __init__(self, cmd: List[str], env: Optional[dict], num_processes: int):
        self._store, group = hosted_store()
        base = {**(dict(env) if env is not None else dict(os.environ)), **group}
        port = int(group["MASTER_PORT"])
        self.args = cmd
        self.returncode: Optional[int] = None
        self._failed_at: Optional[float] = None
        self._first_failure: Optional[int] = None
        self._stopped = 0
        self.procs = [subprocess.Popen(cmd, env=rank_env(base, i, num_processes, port))
                      for i in range(num_processes)]

    @property
    def pid(self) -> int:
        return self.procs[0].pid

    def poll(self) -> Optional[int]:
        codes = [p.poll() for p in self.procs]
        if self._first_failure is None:
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                self._first_failure, self._failed_at = failed[0], time.monotonic()
        if all(c is not None for c in codes):
            self.returncode = self._first_failure if self._first_failure is not None else 0
            return self.returncode
        if self._failed_at is not None:
            # A rank that waits in a collective for the failed one never returns.
            late = time.monotonic() - self._failed_at
            if late > 2 * GRACE_S and self._stopped < 2:
                self.send_signal(signal.SIGKILL)
                self._stopped = 2
            elif late > GRACE_S and self._stopped < 1:
                self.send_signal(signal.SIGTERM)
                self._stopped = 1
        return None

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired(self.args, timeout)
            time.sleep(POLL_S)
        return self.returncode

    def send_signal(self, signum):
        """`signum` to every child still running."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(signum)
                except (ProcessLookupError, OSError):
                    pass

    def kill(self):
        self.send_signal(signal.SIGKILL)


def spawn(cmd: List[str], env: Optional[dict], num_processes: int = 1):
    """One plain child of `cmd` (no group), or a `LocalProcesses` group."""
    if num_processes > 1:
        return LocalProcesses(cmd, env, num_processes)
    return subprocess.Popen(cmd, env=env)


def _debug_worker(index: int, function, args, env: dict, error_dir: str):
    """A child: the launcher's variables first, then `function`; a failure
    leaves its traceback in ``rank<index>.err`` and exits 1."""
    os.environ.update(env)
    os.environ["RANK"] = os.environ["LOCAL_RANK"] = str(index)
    try:
        import torch

        if env.get("ACCELERATE_TPU_USE_CPU") == "1":
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


def _launch_functions(function: Callable, args, num_processes: int, env: dict, timeout: Optional[float], name: str):
    """Spawn `num_processes` children of ``function(*args)`` with `env` and
    wait for all; see `debug_launcher`. Without ``MASTER_PORT`` in `env`
    they meet at a store this process hosts for them (`hosted_store`, at
    ``MASTER_ADDR`` if `env` names one)."""
    import multiprocessing

    store = None  # held until the children are done
    if "MASTER_PORT" not in env:
        store, group = hosted_store(env.get("MASTER_ADDR", "127.0.0.1"))
        env = {**env, **group}
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
            time.sleep(POLL_S)
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
            raise RuntimeError(f"{name}: {len(failed)}/{num_processes} processes failed:\n" + "\n".join(msgs))


def debug_launcher(function: Callable, args=(), num_processes: int = 2, timeout: Optional[float] = None):
    """Run ``function(*args)`` in `num_processes` CPU processes over gloo and
    wait for all of them. Each child runs torch on one thread (the test
    suite runs several workers already). When a child fails, the others get
    `GRACE_S` seconds to finish (a collective they wait in would never
    return) and are then terminated; the error names every child that
    failed, with its traceback. `timeout` bounds the whole run."""
    env = {
        "WORLD_SIZE": str(num_processes),
        "ACCELERATE_TPU_USE_CPU": "1",
        "ACCELERATE_TPU_DEBUG_LAUNCHER": "1",
        "OMP_NUM_THREADS": str(THREADS),
    }
    _launch_functions(function, args, num_processes, env, timeout, "debug_launcher")


def card_launcher(function: Callable, args=(), num_processes: int = 1, use_port: Optional[str] = None,
                  master_addr: str = "127.0.0.1", timeout: Optional[float] = None):
    """Run ``function(*args)`` in one process per card over NCCL, process i
    on card i, meeting at `master_addr`: on `use_port` when one is given,
    else at a store this process hosts there; raises when there are fewer
    cards than `num_processes`."""
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if num_processes > cards:
        raise ValueError(f"num_processes={num_processes} needs one card a process; this host has {cards} "
                         "(NCCL takes one rank per device)")
    env = {"WORLD_SIZE": str(num_processes), "MASTER_ADDR": master_addr}
    if use_port:
        env["MASTER_PORT"] = str(use_port)
    _launch_functions(function, args, num_processes, env, timeout, "card_launcher")


def notebook_launcher(
    function: Callable,
    args=(),
    num_processes: Optional[int] = None,
    mixed_precision: str = "no",
    use_port: str = "29500",
    master_addr: str = "127.0.0.1",
    node_rank: int = 0,
    num_nodes: int = 1,
):
    """Run a training function from a notebook (JAX's `notebook_launcher`).

    On the card one process runs ``function(*args)`` here; ``num_processes
    > 1`` spawns one process per card over NCCL on `master_addr`:`use_port`
    (`card_launcher`). Without a card, or under ``ACCELERATE_TPU_USE_CPU``,
    ``num_processes > 1`` runs `debug_launcher`'s gloo processes instead.
    `node_rank` and `num_nodes` are taken for JAX's signature (one node)."""
    from .state import AcceleratorState, PartialState
    from .utils.dataclasses import parse_flag_from_env

    if AcceleratorState._shared_state or PartialState._shared_state:
        raise ValueError(
            "An `Accelerator` (or `PartialState`) already exists in this process. "
            "Restart the notebook kernel and call notebook_launcher before creating one."
        )
    if mixed_precision not in ("no", "fp16", "bf16", "fp8"):
        raise ValueError(f"Unknown mixed_precision mode: {mixed_precision!r}")
    os.environ["ACCELERATE_TPU_MIXED_PRECISION"] = mixed_precision

    import torch

    cpu = parse_flag_from_env("ACCELERATE_TPU_USE_CPU") or not torch.cuda.is_available()
    if num_processes is not None and num_processes > 1:
        if cpu:
            return debug_launcher(function, args=args, num_processes=num_processes)
        return card_launcher(function, args=args, num_processes=num_processes, use_port=use_port,
                             master_addr=master_addr)
    return function(*args)
