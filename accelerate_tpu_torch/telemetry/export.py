"""Metric exporters (the port of `accelerate_tpu/telemetry/export.py`):
JSONL snapshots, the Prometheus text format (file and stdlib-HTTP
``/metrics``), the Chrome/Perfetto trace-event writer for the flight
recorder's spans, and a bridge into the `tracking.py` trackers.

Offline-first, like tracking.py: training hosts often have no egress, so the
always-works paths are files — an append-only JSONL history a postmortem can
replay, and an atomically-replaced Prometheus textfile the standard
node-exporter ``textfile`` collector scrapes. The HTTP endpoint is optional and
pure stdlib (no prometheus_client dependency, which the image doesn't bake in).

`parse_prometheus_text` is the inverse of `to_prometheus_text` for the subset
this module emits — the round-trip is pinned by tests (and is the acceptance
criterion for the serving histograms): what a Prometheus scraper ingests is
exactly what the registry measured.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, Optional, Tuple

from ..checkpointing import atomic_write
from .metrics import Histogram, MetricsRegistry

logger = logging.getLogger(__name__)


def _fmt_value(v: float) -> str:
    """Prometheus sample values: integers render bare (counter readability),
    floats in repr precision (round-trip exactness)."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _fmt_labels(labels: Dict[str, str], extra: Optional[Dict[str, str]] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n"))
        for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


def to_prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in the Prometheus exposition text format.

    Histograms follow the standard encoding: cumulative ``_bucket`` series with
    ``le`` upper-bound labels (ending at ``+Inf``), plus ``_sum`` and
    ``_count``. ``# TYPE``/``# HELP`` headers are emitted once per metric name.
    """
    lines = []
    seen_headers = set()
    for inst in registry.instruments():
        if inst.name not in seen_headers:
            seen_headers.add(inst.name)
            if inst.help:
                lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
        if isinstance(inst, Histogram):
            cumulative = 0
            counts = inst.bucket_counts()
            for bound, count in zip(inst.bucket_bounds, counts[:-1]):
                cumulative += count
                lines.append(
                    f"{inst.name}_bucket{_fmt_labels(inst.label_dict, {'le': _fmt_value(bound)})} {cumulative}"
                )
            cumulative += counts[-1]
            lines.append(
                f"{inst.name}_bucket{_fmt_labels(inst.label_dict, {'le': '+Inf'})} {cumulative}"
            )
            lines.append(f"{inst.name}_sum{_fmt_labels(inst.label_dict)} {_fmt_value(inst.sum)}")
            lines.append(f"{inst.name}_count{_fmt_labels(inst.label_dict)} {cumulative}")
        else:
            lines.append(f"{inst.name}{_fmt_labels(inst.label_dict)} {_fmt_value(inst.value)}")
    return "\n".join(lines) + "\n"


def _unescape_label_value(value: str) -> str:
    """Decode the exposition-format escapes in ONE left-to-right pass:
    sequential str.replace would mis-decode a value containing a literal
    backslash followed by 'n' (escaped on the wire as two backslashes + n)."""
    out, i = [], 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == '"':
                out.append('"')
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_labels(block: str) -> Tuple[Tuple[str, str], ...]:
    labels = []
    for part in _split_label_pairs(block):
        key, _eq, raw = part.partition("=")
        value = _unescape_label_value(raw.strip()[1:-1])  # strip quotes
        labels.append((key.strip(), value))
    return tuple(sorted(labels))


def _split_label_pairs(block: str):
    """Split `a="x",b="y"` on commas outside quotes (values may contain ',')."""
    parts, buf, in_quotes, escaped = [], [], False, False
    for ch in block:
        if escaped:
            buf.append(ch)
            escaped = False
            continue
        if ch == "\\":
            buf.append(ch)
            escaped = True
            continue
        if ch == '"':
            in_quotes = not in_quotes
        if ch == "," and not in_quotes:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return [p for p in (s.strip() for s in parts) if p]


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Parse the subset `to_prometheus_text` emits back into plain data:
    ``{series_name: {"type": kind, "samples": {labels_tuple: value}}}`` where
    histogram series appear under their ``_bucket``/``_sum``/``_count`` names
    (the wire truth a scraper sees). Unknown/malformed lines are skipped with a
    warning — a parser for monitoring must never crash monitoring."""
    out: Dict[str, dict] = {}
    types: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            fields = line.split(None, 3)
            if len(fields) >= 4 and fields[1] == "TYPE":
                types[fields[2]] = fields[3]
            continue
        try:
            if "{" in line:
                name, rest = line.split("{", 1)
                label_block, value_part = rest.rsplit("}", 1)
                labels = _parse_labels(label_block)
                value = float(value_part.strip())
            else:
                name, value_part = line.rsplit(None, 1)
                labels = ()
                value = float(value_part)
        except ValueError:
            logger.warning("skipping malformed prometheus line: %r", line)
            continue
        name = name.strip()
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in types:
                base = name[: -len(suffix)]
                break
        series = out.setdefault(name, {"type": types.get(base, "untyped"), "samples": {}})
        series["samples"][labels] = value
    return out


def write_prometheus_textfile(registry: MetricsRegistry, path: str) -> str:
    """Atomically replace `path` with the current exposition (temp + fsync +
    rename, via checkpointing.atomic_write): a node-exporter textfile collector
    scraping mid-write sees the previous complete snapshot, never a torn one."""
    text = to_prometheus_text(registry)
    atomic_write(path, lambda f: f.write(text), mode="w")
    return path


def write_jsonl_snapshot(registry: MetricsRegistry, path: str, step: Optional[int] = None, **extra) -> dict:
    """Append one self-contained snapshot line (wall time + full registry dump)
    to a JSONL history — the postmortem format: replay the file to see every
    metric's trajectory, no scraper required."""
    record = {"time": time.time(), "metrics": registry.snapshot()}
    if step is not None:
        record["step"] = step
    record.update(extra)
    with open(path, "a") as f:
        f.write(json.dumps(record, default=str) + "\n")
    return record


# ------------------------------------------------------------------ trace events
def _us(t_unix: float) -> int:
    """Trace-event timestamps are integer microseconds."""
    return int(round(float(t_unix) * 1e6))


def _trace_args(record: dict) -> Dict[str, object]:
    """Span ids ride in `args` so Perfetto's query/selection UI can correlate
    a request across processes; user attrs come after (and win on clash is
    impossible — attr names are user-chosen, ids are namespaced)."""
    args: Dict[str, object] = {
        "trace_id": record.get("trace_id"),
        "span_id": record.get("span_id"),
    }
    if record.get("parent_id"):
        args["parent_id"] = record["parent_id"]
    args.update(record.get("attrs") or {})
    return args


def to_trace_events(records) -> dict:
    """Render flight-recorder records as a Chrome trace-event JSON object
    (the format chrome://tracing and Perfetto load directly).

    - completed spans     -> ``"ph": "X"`` complete events (ts + dur, µs);
    - in-span events      -> ``"ph": "i"`` thread-scoped instants inside them;
    - standalone events   -> ``"ph": "i"`` process-scoped instants;
    - dangling span_start -> ``"ph": "B"`` begin events with no matching end —
      Perfetto renders them as unfinished, which is exactly what a span that
      died with its process IS (the crash boundary, visually).

    Timestamps are the records' unix-anchored times, so spans streamed by a
    supervisor and three restarted workers land on ONE comparable timeline.
    """
    events = []
    seen_pids = set()
    ended = {r.get("span_id") for r in records if r.get("kind") == "span"}
    for record in records:
        kind = record.get("kind", "span")
        pid = record.get("pid", 0)
        tid = record.get("tid", 0)
        seen_pids.add(pid)
        if kind == "span":
            start = record.get("start_unix", 0.0)
            end = record.get("end_unix", start)
            events.append({
                "ph": "X",
                "name": record.get("name", "?"),
                "cat": record.get("cat", "default"),
                "ts": _us(start),
                "dur": max(_us(end) - _us(start), 0),
                "pid": pid,
                "tid": tid,
                "args": _trace_args(record),
            })
            for ev in record.get("events", ()):
                events.append({
                    "ph": "i",
                    "s": "t",
                    "name": ev.get("name", "?"),
                    "cat": record.get("cat", "default"),
                    "ts": _us(ev.get("t_unix", start)),
                    "pid": pid,
                    "tid": tid,
                    "args": dict(ev.get("attrs") or {}),
                })
        elif kind == "span_start":
            if record.get("span_id") in ended:
                continue  # the completed span supersedes its start record
            events.append({
                "ph": "B",
                "name": record.get("name", "?"),
                "cat": record.get("cat", "default"),
                "ts": _us(record.get("start_unix", 0.0)),
                "pid": pid,
                "tid": tid,
                "args": _trace_args(record),
            })
        elif kind == "event":
            events.append({
                "ph": "i",
                "s": "p",
                "name": record.get("name", "?"),
                "cat": record.get("cat", "default"),
                "ts": _us(record.get("t_unix", 0.0)),
                "pid": pid,
                "tid": tid,
                "args": _trace_args(record),
            })
    events.sort(key=lambda e: (e["pid"], e["ts"]))
    meta = [
        {
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"accelerate-tpu pid {pid}"},
        }
        for pid in sorted(seen_pids)
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_trace_events(records, path: str) -> str:
    """Atomically write records as a Perfetto-loadable trace JSON (temp +
    fsync + rename — a dump racing a crash must be whole or absent)."""
    payload = json.dumps(to_trace_events(records))
    atomic_write(path, lambda f: f.write(payload), mode="w")
    return path


class MetricsHTTPServer:
    """Optional stdlib ``/metrics`` endpoint (one daemon thread, no deps).

    ``port=0`` binds an ephemeral port (read it back from ``.port``) — the test
    and notebook default. Serving happens outside the hot path entirely: a
    scrape renders a snapshot under the instruments' own locks, so the step
    loop never blocks on a scraper (and vice versa).
    """

    def __init__(self, registry: MetricsRegistry, port: int = 0, host: str = "127.0.0.1"):
        import http.server

        self.registry = registry
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.rstrip("/") not in ("", "/metrics".rstrip("/"), "/metrics"):
                    self.send_error(404)
                    return
                body = to_prometheus_text(outer.registry).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not stderr news
                pass

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-http", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


class TrackerBridge:
    """Publish registry snapshots through the experiment trackers
    (the port's `Accelerator.log` fan-out): counters/gauges as scalars, histograms as
    count / sum / p50 / p99 — the flattening every tracker backend can ingest.

    The bridge is pull-based (`publish(step)` at whatever cadence the loop
    likes) so tracker I/O — files, network — never rides the step hot path.
    """

    def __init__(self, accelerator, registry: Optional[MetricsRegistry] = None, prefix: str = "telemetry/"):
        self.accelerator = accelerator
        self.registry = registry if registry is not None else getattr(accelerator, "telemetry", None)
        if self.registry is None:
            raise ValueError("TrackerBridge needs a registry (or an Accelerator with .telemetry)")
        self.prefix = prefix

    def flatten(self) -> Dict[str, float]:
        values: Dict[str, float] = {}
        for inst in self.registry.instruments():
            suffix = "".join(f".{k}={v}" for k, v in sorted(inst.label_dict.items()))
            base = f"{self.prefix}{inst.name}{suffix}"
            if isinstance(inst, Histogram):
                values[f"{base}.count"] = float(inst.count)
                values[f"{base}.sum"] = inst.sum
                for q in (0.5, 0.99):
                    quantile = inst.quantile(q)
                    if quantile is not None:
                        values[f"{base}.p{int(q * 100)}"] = quantile
            else:
                values[base] = inst.value
        return values

    def publish(self, step: Optional[int] = None) -> Dict[str, float]:
        values = self.flatten()
        self.accelerator.log(values, step=step)
        return values
