"""Restart supervision (the port of `accelerate_tpu/fault_tolerance.py`'s
`Supervisor`).

`Supervisor` runs the training command as a child, restarts it on failure
up to `max_restarts` times with a linear backoff under a cap, forwards
SIGTERM and SIGINT and gives the child `grace_period` seconds before the hard
kill, and stops early on a crash loop (the same exit code from a child that
died young, `crash_loop_threshold` times in a row) or on no forward progress
(`progress_fn`'s token unchanged over `no_progress_threshold` failed
attempts). Exit code 0 and `PREEMPTED_EXIT_CODE` (143) end supervision.
This is what ``accelerate-tpu-torch launch --max_restarts N`` wraps around
the user's script. With ``num_processes > 1`` the child is a whole
`launchers.LocalProcesses` group, one process a rank, restarted as one unit
on a fresh port, as torchrun's agent restarts a worker group.

With a `tracer`, each attempt is a ``supervisor.attempt`` span ended with
its exit code, followed by a ``supervisor.child_exit`` event, and the trace
context (the trace id, the attempt span as parent, the trace directory) goes
into the child's environment through `Tracer.inject_env`; the worker's
default tracer reads it back (`Tracer.from_env`), so a restarted run
stitches into one trace.

`PreemptionHandler` is the worker's side: a latch on SIGTERM (and SIGINT
when asked) that `Accelerator.register_preemption_checkpoint` installs and
`Accelerator.check_preemption` reads at a step boundary, where it saves
and exits with `PREEMPTED_EXIT_CODE`, which ends supervision.

The supervisor is not one of the group's processes: it logs through plain
`logging` and builds no `PartialState`.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import threading
import time
from typing import Callable, List, Optional

from .launchers import spawn

logger = logging.getLogger(__name__)

PREEMPTED_EXIT_CODE = 143  # 128 + SIGTERM, the conventional graceful-preemption code


class Supervisor:
    """Restart a child command (or a group of `num_processes` children) on
    failure, JAX's elastic agent. Exit code 0 and `PREEMPTED_EXIT_CODE` end
    supervision; any other exit restarts until the budget is spent."""

    def __init__(
        self,
        cmd: List[str],
        env: Optional[dict] = None,
        max_restarts: int = 0,
        grace_period: float = 30.0,
        backoff_seconds: float = 1.0,
        max_backoff_seconds: float = 30.0,
        monitor_interval: float = 0.5,
        crash_loop_threshold: int = 3,
        crash_loop_min_uptime: float = 3.0,
        progress_fn: Optional[Callable[[], object]] = None,
        no_progress_threshold: int = 0,
        tracer=None,
        num_processes: int = 1,
    ):
        self.cmd = cmd
        self.env = env
        self.tracer = tracer
        self.num_processes = num_processes
        self.max_restarts = max_restarts
        self.grace_period = grace_period
        self.backoff_seconds = backoff_seconds
        self.max_backoff_seconds = max_backoff_seconds
        # How late a grace-period expiry can be noticed.
        self.monitor_interval = monitor_interval
        self.crash_loop_threshold = crash_loop_threshold
        self.crash_loop_min_uptime = crash_loop_min_uptime
        self.progress_fn = progress_fn
        self.no_progress_threshold = no_progress_threshold
        self.crash_loop_detected = False
        #: Which detector tripped: "fast_identical_exits" | "no_forward_progress".
        self.crash_loop_reason: Optional[str] = None
        self._consecutive_no_progress = 0
        self._last_progress_token: object = None
        self._consecutive_fast_identical = 0
        self._last_exit_code: Optional[int] = None
        self.restart_count = 0
        #: Seconds slept between a child's death and its respawn.
        self.downtime_s = 0.0
        self._child = None
        self._terminating = False
        self._kill_deadline: Optional[float] = None

    def _forward_signal(self, signum, frame):
        """Runs on top of the interrupted `wait()`, which may hold the
        child's wait lock: it only latches the flag, stamps the kill
        deadline and forwards the signal; `_monitor` enforces the grace."""
        self._terminating = True
        if self._kill_deadline is None:
            self._kill_deadline = time.monotonic() + self.grace_period
        child = self._child
        if child is not None:
            logger.info("supervisor: forwarding signal %d to pid %d", signum, child.pid)
            try:
                child.send_signal(signum)
            except (ProcessLookupError, OSError):
                pass  # gone already; _monitor reaps it

    def _monitor(self, child) -> int:
        """Timed `wait()` cycles: a child's exit is seen at once, a grace
        expiry within one `monitor_interval`."""
        while True:
            timeout = self.monitor_interval
            if self._kill_deadline is not None:
                timeout = min(timeout, max(self._kill_deadline - time.monotonic(), 0.01))
            try:
                return child.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                if self._kill_deadline is not None and time.monotonic() >= self._kill_deadline:
                    logger.warning("supervisor: grace period expired; killing pid %d", child.pid)
                    child.kill()
                    return child.wait()

    def _next_backoff(self) -> float:
        """Linear backoff, capped at `max_backoff_seconds`."""
        return min(self.backoff_seconds * self.restart_count, self.max_backoff_seconds)

    def _attempt_span(self, attempt: int):
        if self.tracer is None:
            return None
        return self.tracer.start_span("supervisor.attempt", category="supervisor", attempt=attempt,
                                      restarts=self.restart_count)

    def _child_env(self, span) -> Optional[dict]:
        if self.tracer is None:
            return self.env
        env = dict(self.env) if self.env is not None else dict(os.environ)
        return self.tracer.inject_env(env, parent=span)

    def _crash_loop(self, code: int, uptime: float) -> bool:
        """Update both detectors with a failed attempt; True to stop."""
        if self.progress_fn is not None and self.no_progress_threshold > 0:
            token = self.progress_fn()
            self._consecutive_no_progress = self._consecutive_no_progress + 1 if token == self._last_progress_token else 0
            self._last_progress_token = token
            if self._consecutive_no_progress >= self.no_progress_threshold:
                self.crash_loop_reason = "no_forward_progress"
                logger.error(
                    "supervisor: CRASH LOOP — %d consecutive failed attempts with no forward progress "
                    "(progress token stuck at %r); refusing further restarts (%d restart(s) left unused). "
                    "diagnostic=crash_loop", self._consecutive_no_progress, token,
                    max(self.max_restarts - self.restart_count, 0))
        fast = uptime < self.crash_loop_min_uptime
        if fast and code == self._last_exit_code:
            self._consecutive_fast_identical += 1
        else:
            self._consecutive_fast_identical = 1 if fast else 0
        self._last_exit_code = code
        if self.crash_loop_reason is None and 0 < self.crash_loop_threshold <= self._consecutive_fast_identical:
            self.crash_loop_reason = "fast_identical_exits"
            logger.error(
                "supervisor: CRASH LOOP — %d consecutive crashes with identical exit code %d, each alive < %.1fs; "
                "refusing further restarts (%d restart(s) left unused). diagnostic=crash_loop",
                self._consecutive_fast_identical, code, self.crash_loop_min_uptime,
                max(self.max_restarts - self.restart_count, 0))
        self.crash_loop_detected = self.crash_loop_reason is not None
        return self.crash_loop_detected

    def run(self) -> int:
        prev_term = signal.signal(signal.SIGTERM, self._forward_signal)
        prev_int = signal.signal(signal.SIGINT, self._forward_signal)
        attempt = 0
        if self.progress_fn is not None:
            self._last_progress_token = self.progress_fn()
        try:
            while True:
                attempt += 1
                span = self._attempt_span(attempt)
                spawned_at = time.monotonic()
                self._child = spawn(self.cmd, self._child_env(span), self.num_processes)
                code = self._monitor(self._child)
                if span is not None:
                    span.annotate(exit_code=code).end()
                    # Streamed at once: the crash boundary a trace report names.
                    self.tracer.event("supervisor.child_exit", category="supervisor", attempt=attempt,
                                      exit_code=code)
                if code == 0 or code == PREEMPTED_EXIT_CODE or self._terminating:
                    return code
                if self._crash_loop(code, time.monotonic() - spawned_at):
                    return code
                if self.restart_count >= self.max_restarts:
                    logger.warning("supervisor: child failed (exit %d); restart budget (%d) exhausted", code,
                                   self.max_restarts)
                    return code
                self.restart_count += 1
                logger.warning("supervisor: child failed (exit %d); restart %d/%d", code, self.restart_count,
                               self.max_restarts)
                backoff = self._next_backoff()
                self.downtime_s += backoff
                time.sleep(backoff)
        finally:
            signal.signal(signal.SIGTERM, prev_term)
            signal.signal(signal.SIGINT, prev_int)


class PreemptionHandler:
    """A latch on SIGTERM (and SIGINT with `catch_sigint`) for a graceful
    preemption (JAX's): the signal sets `preemption_requested`, and
    `on_preempt` runs in the handler. Standalone::

        handler = PreemptionHandler()
        for batch in loader:
            ...
            if handler.preemption_requested:
                accelerator.save_state(ckpt_dir); sys.exit(PREEMPTED_EXIT_CODE)

    `signal.signal` works on the main thread only: built on another, the
    handler warns and stays a latch that never sets (`installed` False)
    rather than raise in the script it protects."""

    def __init__(self, catch_sigint: bool = False, on_preempt: Optional[Callable] = None):
        self._requested = threading.Event()
        self.on_preempt = on_preempt
        self._prev = {}
        self.installed = True
        for sig in [signal.SIGTERM] + ([signal.SIGINT] if catch_sigint else []):
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:
                self.installed = False
                self._prev = {}
                logger.warning(
                    "PreemptionHandler constructed off the main thread; SIGTERM latch disabled "
                    "(preemption_requested will stay False). Construct the handler, or call "
                    "register_preemption_checkpoint, from the main thread to enable graceful preemption "
                    "checkpoints.")
                break

    def _handle(self, signum, frame):
        logger.warning("preemption signal %d received; will checkpoint at step boundary", signum)
        self._requested.set()
        if self.on_preempt is not None:
            self.on_preempt()

    @property
    def preemption_requested(self) -> bool:
        return self._requested.is_set()

    def reset(self):
        self._requested.clear()

    def uninstall(self):
        """Put back the handlers that were there before."""
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}
