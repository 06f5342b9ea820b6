"""On-demand profiler capture: programmatic `torch.profiler` sessions you can
trigger on a LIVE run (the port of `accelerate_tpu/telemetry/profiler.py`).

`ProfilerManager` owns the profiler lifecycle so a capture can be demanded
from outside at the moment something looks wrong:

  - **touch-file trigger**: `touch <log_dir>/CAPTURE` on the host — the next
    `poll()` at a step boundary consumes the file and opens a fixed-duration
    trace window;
  - **signal trigger**: SIGUSR2 latches a capture request (degrading to a
    warning off the main thread);
  - **fixed-duration windows**: a triggered capture stops itself after
    `capture_seconds` of wall clock (checked at `poll()` boundaries), so an
    unattended trigger can never fill the disk with an unbounded trace;
  - **device-memory snapshots**: `save_memory_snapshot()` dumps the CUDA
    caching allocator's state next to the traces.

The real backend is `torch.profiler.profile(activities=[CPU, CUDA])`
(CUPTI on the card), which writes one Chrome trace (``trace_<pid>.json``,
kernels by name on the device's rows) into the window's directory: open it
in Perfetto (ui.perfetto.dev) or chrome://tracing. JAX writes an xplane
dump for TensorBoard instead. The memory snapshot is
`torch.cuda.memory._dump_snapshot`'s pickled allocator state (segments and
blocks, and the allocation history when `torch.cuda.memory.
_record_memory_history` is on), read by pytorch.org/memory_viz; it is not
JAX's pprof. On a machine without CUDA the snapshot raises instead of
writing an empty file.

`Accelerator` polls its manager every fused train step and wires
``ACCELERATE_TPU_PROFILE_DIR`` through `from_env`, as JAX's does. The
torch.profiler calls live behind an injectable backend, both for tests and
so that importing this module touches no device.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal as _signal
import threading
import time
from typing import Optional

from .metrics import MetricsRegistry

logger = logging.getLogger(__name__)

#: Name of the trigger file inside ``log_dir`` (touch it to request a capture).
TOUCH_FILE_NAME = "CAPTURE"


class _TorchProfilerBackend:
    """The real profiler: `torch.profiler` over the CPU and, where there is
    one, the CUDA device; imported lazily."""

    def __init__(self):
        self._profile = None
        self._log_dir = None

    def start_trace(self, log_dir: str):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._profile = profile(activities=activities)
        self._profile.__enter__()
        self._log_dir = log_dir

    def stop_trace(self):
        prof, self._profile = self._profile, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(self._log_dir, f"trace_{os.getpid()}.json"))

    def save_device_memory_profile(self, path: str):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("a device-memory snapshot needs a CUDA device; this machine has none")
        torch.cuda.memory._dump_snapshot(path)


class ProfilerManager:
    """Owns programmatic profiler sessions for one process.

    Disabled (``log_dir=None``) every method is a cheap no-op — constructing a
    manager unconditionally (as `Accelerator` does) costs nothing when
    profiling wasn't requested. ``poll()`` is the step-boundary hook: it
    consumes pending triggers and closes expired capture windows; its fast path
    (no capture armed, no trigger) is two attribute reads and one `os.path`
    probe every `poll_every` calls.
    """

    def __init__(
        self,
        log_dir: Optional[str] = None,
        capture_seconds: float = 10.0,
        touch_file: Optional[str] = None,
        poll_every: int = 10,
        registry: Optional[MetricsRegistry] = None,
        backend=None,
        clock=time.monotonic,
    ):
        self.log_dir = str(log_dir) if log_dir else None
        if self.log_dir:
            # The touch-file contract is "touch <log_dir>/CAPTURE on a live
            # run": the directory must exist the moment the manager is armed,
            # not at first capture.
            os.makedirs(self.log_dir, exist_ok=True)
        self.capture_seconds = float(capture_seconds)
        self.touch_file = touch_file or (
            os.path.join(self.log_dir, TOUCH_FILE_NAME) if self.log_dir else None
        )
        self.poll_every = max(1, int(poll_every))
        self.registry = registry if registry is not None else MetricsRegistry()
        self._backend = backend if backend is not None else _TorchProfilerBackend()
        self._clock = clock
        self._lock = threading.Lock()
        self._active = False
        self._deadline: Optional[float] = None
        self._capture_index = 0
        self._polls = 0
        self._signal_latch = threading.Event()
        self._signal_installed = False
        self._captures = self.registry.counter(
            "profiler_captures_total", help="profiler trace windows opened"
        )
        self._active_gauge = self.registry.gauge(
            "profiler_active", help="1 while a trace window is open"
        )
        self._memory_snapshots = self.registry.counter(
            "profiler_memory_snapshots_total", help="device-memory profiles dumped"
        )

    @property
    def enabled(self) -> bool:
        return self.log_dir is not None

    @property
    def active(self) -> bool:
        return self._active

    @classmethod
    def from_env(
        cls,
        default_dir: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        install_signal: bool = True,
        **kwargs,
    ) -> "ProfilerManager":
        """Build from the launch env protocol: ``ACCELERATE_TPU_PROFILE_DIR``
        (the JAX package's `launch --profile_dir` sets it) wins over `default_dir`.
        When the env var armed the manager, the SIGUSR2 trigger is installed
        too — the launch flag means "this run should be profilable from
        outside"."""
        env_dir = os.environ.get("ACCELERATE_TPU_PROFILE_DIR")
        manager = cls(log_dir=env_dir or default_dir, registry=registry, **kwargs)
        if env_dir and install_signal:
            manager.install_signal_handler()
        return manager

    # ---------------------------------------------------------------- triggers
    def install_signal_handler(self, signum: int = _signal.SIGUSR2) -> bool:
        """SIGUSR2 latches a capture request served at the next `poll()`.
        Off the main thread (`signal.signal`'s restriction) this degrades to a
        warn + False — never crash the run it is meant to observe."""
        if not self.enabled or self._signal_installed:
            return self._signal_installed
        try:
            _signal.signal(signum, lambda _s, _f: self._signal_latch.set())
            self._signal_installed = True
        except ValueError:
            logger.warning(
                "ProfilerManager signal trigger disabled (not on the main thread); "
                "the touch-file trigger (%s) still works",
                self.touch_file,
            )
        return self._signal_installed

    def request_capture(self):
        """Programmatic trigger: the next `poll()` opens a capture window."""
        self._signal_latch.set()

    def _consume_trigger(self) -> bool:
        if self._signal_latch.is_set():
            self._signal_latch.clear()
            return True
        if self.touch_file and os.path.exists(self.touch_file):
            try:
                os.remove(self.touch_file)
            except OSError:
                pass  # another process raced the removal; the capture still runs
            return True
        return False

    # ----------------------------------------------------------------- windows
    def start(self, duration_s: Optional[float] = None, subdir: Optional[str] = None) -> Optional[str]:
        """Open a trace window (no-op returning None when disabled or already
        capturing). With `duration_s`, `poll()` closes it once the window
        elapses; without, it stays open until `stop()`."""
        if not self.enabled:
            return None
        with self._lock:
            if self._active:
                return None
            self._capture_index += 1
            name = subdir or f"capture_{self._capture_index:03d}"
            target = os.path.join(self.log_dir, name)
            os.makedirs(target, exist_ok=True)
            self._backend.start_trace(target)
            self._active = True
            self._deadline = (
                self._clock() + float(duration_s) if duration_s is not None else None
            )
        self._captures.inc()
        self._active_gauge.set(1)
        logger.info("profiler capture started -> %s", target)
        return target

    def stop(self) -> bool:
        """Close the open window (idempotent)."""
        with self._lock:
            if not self._active:
                return False
            self._backend.stop_trace()
            self._active = False
            self._deadline = None
        self._active_gauge.set(0)
        logger.info("profiler capture stopped")
        return True

    def poll(self) -> bool:
        """Step-boundary hook: close an expired window, else serve a pending
        trigger with a fixed `capture_seconds` window. Trigger probes run every
        `poll_every` calls (an os.path.exists per step would tax tight decode
        loops); expiry is checked every call so windows close promptly.
        Returns True when a capture is open after the poll."""
        if not self.enabled:
            return False
        if self._active:
            deadline = self._deadline
            if deadline is not None and self._clock() >= deadline:
                self.stop()
            return self._active
        self._polls += 1
        if self._polls % self.poll_every and not self._signal_latch.is_set():
            return False
        if self._consume_trigger():
            self.start(duration_s=self.capture_seconds)
        return self._active

    @contextlib.contextmanager
    def trace(self, subdir: Optional[str] = None):
        """Scoped capture (the `Accelerator.profile` surface): opens a window
        for the block, always closes it. No-op when disabled."""
        target = self.start(subdir=subdir)
        try:
            yield target
        finally:
            if target is not None:
                self.stop()

    # --------------------------------------------------------------- snapshots
    def save_memory_snapshot(self, path: Optional[str] = None) -> Optional[str]:
        """Dump the CUDA allocator snapshot (`torch.cuda.memory._dump_snapshot`,
        a pickle, not JAX's pprof) — works whether or not a trace window is
        open. Default path lands next to the traces; raises without CUDA."""
        if path is None:
            if not self.enabled:
                return None
            path = os.path.join(self.log_dir, f"memory_{self._capture_index:03d}.pickle")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._backend.save_device_memory_profile(path)
        self._memory_snapshots.inc()
        return path
