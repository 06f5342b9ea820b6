"""Request-scoped distributed tracing: spans over the serve/train hot paths
(the port of `accelerate_tpu/telemetry/tracing.py`).

The metrics registry answers "how is the system doing on average"; this
module answers "what happened to THIS request" and "what was the process doing
at second partition". A `Tracer` creates `Span`s — named, attributed intervals on a
monotonic host clock — and hands every finished span to a recorder (the
bounded ring buffer in `flight_recorder.py`), from which Chrome/Perfetto
trace-event JSON is produced on demand.

The same discipline as `metrics.py` applies, because spans ride the decode and
train step loops:

  - **zero device syncs**: span timestamps are `time.monotonic()` arithmetic
    and span attributes/events accept HOST values only (str/int/float/bool/
    None). A tensor reaching an annotation raises `TypeError` before it can
    hide a blocking readback.
  - **no torch import**: this module is pure stdlib, so host-side tools can
    read and stitch traces without an accelerator stack.
  - **bounded memory**: the tracer itself holds only the active-span stack;
    completed spans go to the recorder's fixed-capacity ring.

Cross-process causality uses the launch env protocol (the same two-sided
pattern as ``ACCELERATE_TPU_FAULT_PLAN`` / ``ACCELERATE_TPU_PROFILE_DIR``):

  - ``ACCELERATE_TPU_TRACE_DIR``    — arm a file-backed recorder (streamed
    span JSONL + on-demand/exit dumps), set by ``launch --trace_dir``;
  - ``ACCELERATE_TPU_TRACE_ID``     — the shared trace id, minted once by the
    launcher/supervisor so every restart stitches into ONE timeline;
  - ``ACCELERATE_TPU_TRACE_PARENT`` — the parent span id (the supervisor's
    attempt span), so a worker's root spans parent under the attempt that
    spawned them.

Timestamps are recorded on the monotonic clock (durations are exact, immune
to NTP steps) with a per-tracer unix anchor taken ONCE at construction, so
spans from different processes land on one comparable timeline when stitched.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: Env vars of the cross-process trace protocol (mirrors ACCELERATE_TPU_FAULT_PLAN).
TRACE_DIR_ENV = "ACCELERATE_TPU_TRACE_DIR"
TRACE_ID_ENV = "ACCELERATE_TPU_TRACE_ID"
TRACE_PARENT_ENV = "ACCELERATE_TPU_TRACE_PARENT"

#: Attribute value types a span accepts — host data only.
_HOST_TYPES = (str, bool, int, float, type(None))


def _check_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """The zero-device-sync gate for span annotations: only host values may
    enter a span. A tensor serialized here would force a blocking
    device->host readback on the hot path — reject it loudly instead of
    silently syncing."""
    for key, value in attrs.items():
        if not isinstance(value, _HOST_TYPES):
            raise TypeError(
                f"span annotations take host values (str/int/float/bool/None), got "
                f"{type(value).__name__} for {key!r}: read device values at the step "
                "boundary (.item()/.cpu()) BEFORE annotating — an implicit "
                "conversion here would hide a device sync"
            )
    return dict(attrs)


def new_id() -> str:
    """A 12-hex-char id, unique across processes (no coordination needed)."""
    return os.urandom(6).hex()


class Span:
    """One named interval: monotonic start/end, host-only attributes, and
    in-span instant events. Created through a `Tracer`; `end()` hands the
    completed record to the tracer's recorder (idempotent)."""

    __slots__ = (
        "name", "category", "trace_id", "span_id", "parent_id",
        "start_s", "end_s", "attrs", "events", "_tracer", "_ended",
    )

    def __init__(self, tracer: "Tracer", name: str, category: str,
                 parent_id: Optional[str], attrs: Dict[str, Any]):
        self.name = name
        self.category = category
        self.trace_id = tracer.trace_id
        self.span_id = new_id()
        self.parent_id = parent_id
        self.start_s = tracer._clock()
        self.end_s: Optional[float] = None
        self.attrs = _check_attrs(attrs)
        self.events: List[dict] = []
        self._tracer = tracer
        self._ended = False

    def annotate(self, **attrs):
        """Attach host-value attributes (later keys win)."""
        self.attrs.update(_check_attrs(attrs))
        return self

    def event(self, name: str, **attrs):
        """Record an instant event inside this span (serialized with it)."""
        self.events.append({
            "name": name,
            "t_unix": self._tracer._anchor + self._tracer._clock(),
            "attrs": _check_attrs(attrs),
        })
        return self

    def end(self):
        """Close the span and hand it to the recorder. Idempotent — a span
        double-ended by defensive cleanup records exactly once."""
        if self._ended:
            return self
        self._ended = True
        self.end_s = self._tracer._clock()
        self._tracer._record(self)
        return self

    def to_dict(self) -> dict:
        tracer = self._tracer
        record = {
            "kind": "span",
            "name": self.name,
            "cat": self.category,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "pid": tracer.pid,
            "tid": threading.get_ident(),
            "start_unix": tracer._anchor + self.start_s,
            "end_unix": tracer._anchor + (self.end_s if self.end_s is not None else self.start_s),
            "duration_s": (self.end_s - self.start_s) if self.end_s is not None else 0.0,
            "attrs": dict(self.attrs),
        }
        if self.events:
            record["events"] = list(self.events)
        return record

    def start_record(self) -> dict:
        """The streamed-at-open record: everything known at span start. A span
        whose end never lands (SIGKILL mid-flight) survives as this record —
        the crash-boundary evidence."""
        tracer = self._tracer
        return {
            "kind": "span_start",
            "name": self.name,
            "cat": self.category,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "pid": tracer.pid,
            "tid": threading.get_ident(),
            "start_unix": tracer._anchor + self.start_s,
            "attrs": dict(self.attrs),
        }


class Tracer:
    """Creates spans and standalone events, tracks the per-thread active-span
    stack (nesting -> parent ids), and feeds a recorder.

    Scoped use (the common form)::

        with tracer.span("serve.decode_chunk", slots=3) as span:
            out = chunk_fn(...)
            span.annotate(tokens=drained)

    Request-lifecycle use (a span outliving any one call frame)::

        span = tracer.start_span("serve.request", request_id=7)
        ...                       # many step() calls later
        span.annotate(finish_reason="eos").end()

    The recorder is any object with ``on_span_start(dict)``/``record(dict)``
    — in practice a `flight_recorder.FlightRecorder`. ``clock`` is injectable
    (a fake clock in tests) and must be monotonic.
    """

    def __init__(
        self,
        recorder=None,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        category: str = "default",
        clock=time.monotonic,
        enabled: bool = True,
    ):
        from .flight_recorder import FlightRecorder  # stdlib-only sibling

        self.recorder = recorder if recorder is not None else FlightRecorder()
        self.trace_id = trace_id or new_id()
        #: Root parent for spans opened with no active span on the stack —
        #: the supervisor's attempt span id when launched under supervision.
        self.root_parent_id = parent_id
        self.category = category
        self.enabled = bool(enabled)
        self.pid = os.getpid()
        self._clock = clock
        # Unix anchor, read ONCE: wall = anchor + monotonic. All measurement
        # stays on the monotonic clock; the anchor only places this process on
        # the shared cross-process timeline at export.
        self._anchor = time.time() - clock()
        self._local = threading.local()
        self._compile_listener_installed = False

    # ------------------------------------------------------------------ context
    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @property
    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def _parent_id(self, parent: Optional[Span]) -> Optional[str]:
        if parent is not None:
            return parent.span_id
        current = self.current_span
        return current.span_id if current is not None else self.root_parent_id

    # ------------------------------------------------------------------ spans
    def start_span(self, name: str, category: Optional[str] = None,
                   parent: Optional[Span] = None, **attrs) -> Span:
        """Open a span WITHOUT putting it on the context stack (request
        lifecycles, supervisor attempts). Caller owns `end()`."""
        span = Span(self, name, category or self.category, self._parent_id(parent), attrs)
        if self.enabled:
            self.recorder.on_span_start(span.start_record())
        return span

    @contextlib.contextmanager
    def span(self, name: str, category: Optional[str] = None,
             parent: Optional[Span] = None, **attrs):
        """Scoped span: pushed on this thread's stack (children nest under it),
        always ended — exceptions mark the span failed and propagate."""
        span = self.start_span(name, category=category, parent=parent, **attrs)
        stack = self._stack()
        stack.append(span)
        try:
            yield span
        except BaseException as exc:
            span.attrs.setdefault("error", repr(exc))
            raise
        finally:
            stack.pop()
            span.end()

    @contextlib.contextmanager
    def activate(self, span: Span):
        """Make an already-open span the context parent for the block (used to
        nest scoped spans under a long-lived lifecycle span). Does NOT end it."""
        stack = self._stack()
        stack.append(span)
        try:
            yield span
        finally:
            stack.pop()

    def event(self, name: str, category: Optional[str] = None, **attrs) -> dict:
        """A standalone instant event, recorded (and streamed) immediately —
        the right shape for fault injections and crash boundaries, which must
        hit durable storage BEFORE the fault they describe lands."""
        record = {
            "kind": "event",
            "name": name,
            "cat": category or self.category,
            "trace_id": self.trace_id,
            "span_id": new_id(),
            "parent_id": self._parent_id(None),
            "pid": self.pid,
            "tid": threading.get_ident(),
            "t_unix": self._anchor + self._clock(),
            "attrs": _check_attrs(attrs),
        }
        if self.enabled:
            self.recorder.record(record)
        return record

    def _record(self, span: Span):
        if self.enabled:
            self.recorder.record(span.to_dict())

    # ------------------------------------------------------------------ wiring
    def attach_compile_listener(self):
        """Record every kernel build (`ops._build`: one ``nvcc`` per source,
        the only compile an eager port makes) as a ``compile`` span named by
        its source (``flash_attention``, ``paged_attention``) and ending now,
        so builds show up ON the timeline instead of as mystery gaps between
        the first steps. A finishing build is liveness: it feeds the hang
        watchdog. The listener stays registered for the process's life, as
        JAX's `jax.monitoring` one does."""
        if self._compile_listener_installed:
            return
        from ..ops import _build

        def on_build(name: str, seconds: float):
            parent = self.current_span
            span = Span(self, name, "compile", self._parent_id(parent), {"duration_s": float(seconds)})
            span.start_s = span.start_s - float(seconds)
            span.end()
            heartbeat = getattr(self.recorder, "heartbeat", None)
            if heartbeat is not None:
                heartbeat()

        _build.add_build_listener(on_build)
        self._compile_listener_installed = True

    def inject_env(self, env: Dict[str, str], parent: Optional[Span] = None) -> Dict[str, str]:
        """Write the trace context into a child process env (the Supervisor →
        worker seam): trace id, parent span id, and the recorder's dir so the
        child streams into the same artifact set."""
        env[TRACE_ID_ENV] = self.trace_id
        parent_id = parent.span_id if parent is not None else (
            self.current_span.span_id if self.current_span is not None else self.root_parent_id
        )
        if parent_id:
            env[TRACE_PARENT_ENV] = parent_id
        log_dir = getattr(self.recorder, "log_dir", None)
        if log_dir:
            env[TRACE_DIR_ENV] = str(log_dir)
        return env

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None,
                 default_dir: Optional[str] = None, **kwargs) -> "Tracer":
        """Build from the launch env protocol: ``ACCELERATE_TPU_TRACE_DIR``
        arms a file-backed recorder (streamed spans + exit dumps), and the
        propagated trace/parent ids stitch this process into the launcher's
        timeline. With nothing set, the tracer still runs with an in-memory
        flight recorder — the last N spans are always available for a dump."""
        from .flight_recorder import FlightRecorder

        environ = environ if environ is not None else os.environ
        log_dir = environ.get(TRACE_DIR_ENV) or default_dir
        recorder = kwargs.pop("recorder", None)
        if recorder is None:
            recorder = FlightRecorder(log_dir=log_dir)
        return cls(
            recorder=recorder,
            trace_id=environ.get(TRACE_ID_ENV) or None,
            parent_id=environ.get(TRACE_PARENT_ENV) or None,
            **kwargs,
        )


# ---------------------------------------------------------------- default tracer
_default_lock = threading.Lock()
_default_tracer: Optional[Tracer] = None


def default_tracer() -> Tracer:
    """The process-wide tracer, built lazily from the env protocol on first
    use. Subsystems that aren't handed an explicit tracer (a bare
    `ContinuousBatcher`, an `Accelerator` outside a launch) share this one, so
    a single `trace dump` covers the whole process."""
    global _default_tracer
    with _default_lock:
        if _default_tracer is None:
            _default_tracer = Tracer.from_env()
        return _default_tracer


def set_default_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Replace (or with None: reset) the process-wide tracer; returns the
    previous one. Tests and embedding servers use this to redirect default
    instrumentation into their own recorder."""
    global _default_tracer
    with _default_lock:
        previous, _default_tracer = _default_tracer, tracer
        return previous
