"""Crash/hang flight recorder: the bounded span ring buffer and its dumpers
(the port of `accelerate_tpu/telemetry/flight_recorder.py`).

An opaque hang leaves nothing to explain it afterwards: the process had been
doing *something*, but the evidence died with it. The `FlightRecorder` keeps the last `capacity` completed spans and
instant events in memory (bounded forever, like the metrics histograms) and
turns them into artifacts at exactly the moments evidence is about to vanish:

  - **on demand** — touching ``<dir>/DUMP`` asks for a dump; the
    next `poll()` at a step/chunk boundary consumes it and writes a Perfetto
    trace-event JSON (the same touch-file pattern as the profiler's CAPTURE);
  - **on exit / SIGTERM** — `install_exit_hooks()` registers an atexit dump
    and a chaining SIGTERM handler, so a clean shutdown or a preemption still
    leaves a timeline behind;
  - **on a hang** — the `HangWatchdog` thread fires when no step-boundary
    heartbeat lands within `deadline_s`: it dumps the trace tail plus
    ALL-thread stack traces (`sys._current_frames`), turning the next
    stall into an artifact instead of a mystery.

When armed with a ``log_dir`` the recorder additionally *streams* every
record to ``spans_<pid>.jsonl`` the moment it lands (flushed line by
line): a SIGKILL tears at most the line in flight, and the spans written
before the kill — including the ``span_start`` record of whatever was open
when the process died — survive as the crash boundary.

Pure stdlib; torch is never imported here. The watchdog's thread is a
daemon, and `remove_exit_hooks()` takes the atexit and SIGTERM hooks out
again, so a test process leaves no handler behind.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import signal as _signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable, List, Optional

from .metrics import MetricsRegistry

logger = logging.getLogger(__name__)

#: Touch this file inside ``log_dir`` to request a dump at the next poll().
DUMP_TOUCH_FILE = "DUMP"


def read_span_jsonl(path: str) -> List[dict]:
    """Read one streamed span file, skipping blank and torn lines (a killed
    writer tears at most the final line; the reader must never crash on it)."""
    records: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        return records
    return records


def collect_trace_dir(log_dir: str) -> List[dict]:
    """Every record streamed into a trace dir (all processes), in time order —
    the stitched raw material for export."""
    records: List[dict] = []
    if not os.path.isdir(log_dir):
        return records
    for name in sorted(os.listdir(log_dir)):
        if name.startswith("spans_") and name.endswith(".jsonl"):
            records.extend(read_span_jsonl(os.path.join(log_dir, name)))
    records.sort(key=lambda r: r.get("start_unix", r.get("t_unix", 0.0)))
    return records


def format_thread_stacks() -> str:
    """Every live thread's current stack — what the process was doing RIGHT
    NOW. This is the payload a hang dump needs: 'where was the main thread
    blocked'."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines: List[str] = []
    for tid, frame in sorted(sys._current_frames().items()):
        lines.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---")
        lines.extend(line.rstrip("\n") for line in traceback.format_stack(frame))
    return "\n".join(lines) + "\n"


class FlightRecorder:
    """Bounded ring of completed spans/events + the dump machinery.

    In-memory by default (`log_dir=None`): `record()` is a lock + deque append,
    cheap enough to ride every request. With a `log_dir`, records also stream
    to ``spans_<pid>.jsonl`` and the touch-file/exit/watchdog dumpers arm.
    """

    def __init__(
        self,
        capacity: int = 4096,
        log_dir: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        poll_every: int = 16,
        clock: Callable[[], float] = time.monotonic,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.log_dir = str(log_dir) if log_dir else None
        self.registry = registry if registry is not None else MetricsRegistry()
        self.poll_every = max(1, int(poll_every))
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._stream = None
        self._dump_index = 0
        self._polls = 0
        self._exit_hooks_installed = False
        self._sigterm = None  # (our handler, the handler it replaced) while installed
        self.watchdog: Optional[HangWatchdog] = None
        self._m_recorded = self.registry.counter(
            "trace_spans_recorded_total", help="spans/events accepted by the flight recorder"
        )
        self._m_evicted = self.registry.counter(
            "trace_spans_evicted_total", help="records pushed out of the bounded ring"
        )
        self._m_dumps = self.registry.counter(
            "trace_dumps_total", help="trace artifacts written (manual/touch/exit/hang)"
        )
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)

    # ------------------------------------------------------------------ intake
    def _stream_write(self, record: dict):
        if self.log_dir is None:
            return
        with self._lock:
            if self._stream is None:
                path = os.path.join(self.log_dir, f"spans_{os.getpid()}.jsonl")
                self._stream = open(path, "a")
            self._stream.write(json.dumps(record) + "\n")
            # Flush per record (no fsync: a span stream is evidence, not a
            # durability contract).
            self._stream.flush()

    def on_span_start(self, record: dict):
        """Streamed immediately so an open span survives a SIGKILL as its
        start record; NOT ring-buffered (the completed span supersedes it)."""
        self._stream_write(record)

    def record(self, record: dict):
        """Accept one completed span / instant event (a plain dict — the
        recorder never holds live Span objects, so the ring is snapshot-safe)."""
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._m_evicted.inc()
            self._ring.append(record)
        self._m_recorded.inc()
        self._stream_write(record)

    def records(self) -> List[dict]:
        """Ring contents, oldest first (eviction order is arrival order)."""
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------------------ dumping
    @property
    def touch_file(self) -> Optional[str]:
        return os.path.join(self.log_dir, DUMP_TOUCH_FILE) if self.log_dir else None

    def dump(self, path: Optional[str] = None, reason: str = "manual") -> Optional[str]:
        """Write the ring as Chrome/Perfetto trace-event JSON. Default path is
        ``<log_dir>/trace_<pid>_<n>.json``; with neither a path nor a log_dir
        there is nowhere to dump (returns None)."""
        from .export import write_trace_events  # lazy: export pulls checkpointing

        if path is None:
            if self.log_dir is None:
                return None
            self._dump_index += 1
            path = os.path.join(
                self.log_dir, f"trace_{os.getpid()}_{self._dump_index:03d}.json"
            )
        write_trace_events(self.records(), path)
        self._m_dumps.inc()
        logger.info("flight recorder dumped %d record(s) -> %s (%s)", len(self), path, reason)
        return path

    def poll(self) -> bool:
        """Step/chunk-boundary hook: consume a pending ``DUMP`` touch file.
        The fast path is one counter increment every call and one
        `os.path.exists` every `poll_every` calls (the profiler's cadence)."""
        if self.log_dir is None:
            return False
        self._polls += 1
        if self._polls % self.poll_every:
            return False
        touch = self.touch_file
        if touch and os.path.exists(touch):
            try:
                os.remove(touch)
            except OSError:
                pass  # another process raced the removal; still dump
            self.dump(reason="touch-file")
            return True
        return False

    # ------------------------------------------------------------------ exit hooks
    def install_exit_hooks(self, catch_sigterm: bool = True) -> "FlightRecorder":
        """Dump on interpreter exit and (chained) on SIGTERM. The SIGTERM hook
        preserves whatever handler was installed before it by calling it after
        the dump; installed off the main thread it degrades to atexit-only (the
        signal module's restriction, same as the profiler trigger).
        `remove_exit_hooks()` undoes both."""
        if self._exit_hooks_installed or self.log_dir is None:
            return self
        self._exit_hooks_installed = True
        atexit.register(self._dump_on_exit)
        if catch_sigterm:
            try:
                prev = _signal.getsignal(_signal.SIGTERM)

                def handler(signum, frame):
                    self.dump(reason="sigterm")
                    if callable(prev):
                        prev(signum, frame)
                    elif prev == _signal.SIG_DFL:
                        _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
                        os.kill(os.getpid(), _signal.SIGTERM)

                _signal.signal(_signal.SIGTERM, handler)
                self._sigterm = (handler, prev)
            except ValueError:
                logger.warning(
                    "flight recorder SIGTERM dump disabled (not on the main thread); "
                    "atexit and touch-file dumps still work"
                )
        return self

    def remove_exit_hooks(self) -> "FlightRecorder":
        """Take the atexit dump out, and put back the SIGTERM handler this
        recorder replaced (only if ours is still the one installed: a later
        handler that chained onto ours stays). Idempotent."""
        if not self._exit_hooks_installed:
            return self
        self._exit_hooks_installed = False
        atexit.unregister(self._dump_on_exit)
        if self._sigterm is not None:
            handler, prev = self._sigterm
            self._sigterm = None
            try:
                if _signal.getsignal(_signal.SIGTERM) is handler:
                    _signal.signal(_signal.SIGTERM, prev if prev is not None else _signal.SIG_DFL)
            except ValueError:
                logger.warning("flight recorder SIGTERM hook left installed (not on the main thread)")
        return self

    def _dump_on_exit(self):
        if len(self):
            try:
                self.dump(reason="exit")
            except Exception:  # noqa: BLE001 — never turn shutdown into a crash
                logger.warning("flight recorder exit dump failed", exc_info=True)

    def close(self):
        with self._lock:
            if self._stream is not None:
                self._stream.close()
                self._stream = None

    # ------------------------------------------------------------------ watchdog
    def heartbeat(self):
        """Step-boundary liveness signal (forwards to the watchdog if armed)."""
        if self.watchdog is not None:
            self.watchdog.heartbeat()

    def start_watchdog(
        self,
        deadline_s: float,
        tracer=None,
        poll_interval_s: float = 1.0,
        clock: Optional[Callable[[], float]] = None,
        start_thread: bool = True,
    ) -> "HangWatchdog":
        """Arm the hang watchdog: if no `heartbeat()` lands within
        `deadline_s`, dump the trace tail + all-thread stacks. One watchdog
        per recorder; re-arming returns the existing one."""
        if self.watchdog is None:
            self.watchdog = HangWatchdog(
                self,
                deadline_s=deadline_s,
                tracer=tracer,
                poll_interval_s=poll_interval_s,
                clock=clock or self._clock,
            )
            if start_thread:
                self.watchdog.start()
        return self.watchdog


class HangWatchdog:
    """Fires when the instrumented loop stops heartbeating.

    The firing is one-shot per stall: after a dump, the watchdog waits for the
    next heartbeat before it can fire again (a 30-minute hang must produce one
    readable artifact, not 1800 of them). The deadline ARMS at the first
    heartbeat — warmup (backend init, the first compiles) legitimately runs
    minutes before the instrumented loop starts, and compile completions count
    as liveness too (the compile-event listener heartbeats), so "hang" means
    the loop went silent MID-RUN. `check_once()` is the synchronous evaluation
    (what the thread loop calls; tests drive it with a FakeClock).
    """

    def __init__(self, recorder: FlightRecorder, deadline_s: float,
                 tracer=None, poll_interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        self.recorder = recorder
        self.deadline_s = float(deadline_s)
        self.tracer = tracer
        self.poll_interval_s = float(poll_interval_s)
        self._clock = clock
        self._last_beat: Optional[float] = None  # armed by the first heartbeat
        self._fired_for_current_stall = False
        self.fired_count = 0
        self.last_dump: Optional[str] = None
        self.last_stacks_path: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def heartbeat(self):
        self._last_beat = self._clock()
        self._fired_for_current_stall = False

    def stalled_s(self) -> float:
        if self._last_beat is None:
            return 0.0  # never armed: warmup is not a stall
        return self._clock() - self._last_beat

    def check_once(self) -> bool:
        """Evaluate the deadline now; fire (dump trace + stacks) on expiry.
        Returns True when this call fired."""
        stalled = self.stalled_s()
        if stalled < self.deadline_s or self._fired_for_current_stall:
            return False
        self._fired_for_current_stall = True
        self.fired_count += 1
        self._fire(stalled)
        return True

    def _fire(self, stalled: float):
        logger.warning(
            "hang watchdog: no step heartbeat for %.1fs (deadline %.1fs) — dumping "
            "trace tail and thread stacks", stalled, self.deadline_s,
        )
        if self.tracer is not None:
            # The event lands in the ring (and the stream) BEFORE the dump, so
            # the dump itself contains the hang marker.
            self.tracer.event(
                "hang.detected", category="watchdog",
                stalled_s=round(stalled, 3), deadline_s=self.deadline_s,
            )
        stacks = format_thread_stacks()
        if self.recorder.log_dir:
            stacks_path = os.path.join(
                self.recorder.log_dir, f"hang_{os.getpid()}_{self.fired_count:03d}.txt"
            )
            with open(stacks_path, "w") as f:
                f.write(
                    f"hang watchdog fired: {stalled:.3f}s without a step heartbeat "
                    f"(deadline {self.deadline_s:.3f}s)\n\n"
                )
                f.write(stacks)
        else:
            stacks_path = None
        self.last_dump = self.recorder.dump(reason="hang") or stacks_path
        self.last_stacks_path = stacks_path

    # ------------------------------------------------------------------ thread
    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="trace-hang-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — the watchdog must outlive its own bugs
                logger.warning("hang watchdog check failed", exc_info=True)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
