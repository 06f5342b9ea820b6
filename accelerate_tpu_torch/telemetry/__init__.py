"""Runtime telemetry of the port: metrics, the step timeline and goodput
ledger, request-scoped tracing with a crash/hang flight recorder, on-demand
profiler capture and the exporters (the port of `accelerate_tpu/telemetry/`,
with the same public names, instrument names, span names and env variables,
so that a dashboard built on one package reads the other).

  - `metrics` — `MetricsRegistry` with Counter/Gauge/Histogram instruments
    (fixed log-spaced latency buckets, host scalars only).
  - `timeline` — `StepTimeline`: per-step data-wait / dispatch / sampled-block
    phases and the goodput ledger (checkpoint saves, restarts, kernel builds,
    `TraceGuard` counts).
  - `tracing` — `Tracer`/`Span` on monotonic host clocks, with the
    ``ACCELERATE_TPU_TRACE_*`` env protocol for cross-process causality.
  - `flight_recorder` — `FlightRecorder` (bounded ring, streamed span JSONL,
    touch-file/exit/SIGTERM dumps) and `HangWatchdog`.
  - `profiler` — `ProfilerManager`: `torch.profiler` windows with touch-file /
    SIGUSR2 triggers, and CUDA allocator snapshots.
  - `export` — JSONL snapshots, Prometheus text (file + stdlib HTTP
    ``/metrics``), Chrome/Perfetto trace-event JSON, and the tracker bridge.

Importing this package builds nothing and touches no device: the profiler
backend and the sampled synchronize import and act only when called.
"""

from .export import (
    MetricsHTTPServer,
    TrackerBridge,
    parse_prometheus_text,
    to_prometheus_text,
    to_trace_events,
    write_jsonl_snapshot,
    write_prometheus_textfile,
    write_trace_events,
)
from .flight_recorder import FlightRecorder, HangWatchdog, collect_trace_dir, read_span_jsonl
from .metrics import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    log_spaced_buckets,
)
from .profiler import ProfilerManager
from .timeline import StepTimeline
from .tracing import Span, Tracer, default_tracer, set_default_tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS",
    "log_spaced_buckets",
    "StepTimeline",
    "ProfilerManager",
    "Tracer",
    "Span",
    "default_tracer",
    "set_default_tracer",
    "FlightRecorder",
    "HangWatchdog",
    "collect_trace_dir",
    "read_span_jsonl",
    "MetricsHTTPServer",
    "TrackerBridge",
    "to_prometheus_text",
    "parse_prometheus_text",
    "write_prometheus_textfile",
    "write_jsonl_snapshot",
    "to_trace_events",
    "write_trace_events",
]
