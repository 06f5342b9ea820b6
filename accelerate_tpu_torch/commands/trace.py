"""``accelerate-tpu-torch trace``: dump, stitch and summarize flight-recorder
traces (the port of `accelerate_tpu/commands/trace.py`).

Subcommands:

  - ``trace dump --dir DIR`` — request a dump from live processes (touches
    ``DIR/DUMP``, served at their next step/chunk boundary) and stitch every
    span stream already in the dir into one Perfetto-loadable trace JSON.
    Exit 0 with the artifact path on stdout; 1 when the dir holds no spans
    yet (the touch file is still left armed); 2 on usage errors.
  - ``trace export FILES... --out OUT`` — convert streamed span JSONL files
    (``spans_<pid>.jsonl``) into one Chrome/Perfetto trace-event JSON,
    stitching across processes (a supervisor + its restarted workers land on
    one timeline, ordered by their unix-anchored timestamps).
  - ``trace report FILE`` — text summary of a span JSONL or trace dir: span
    counts by name, trace ids, crash boundaries, wall-clock extent.

Everything here is host-side file plumbing over the port's
`telemetry.flight_recorder` and `telemetry.export`: it never touches the
card, so it runs on the machine you logged into to find out why a run is
stuck (open the JSON in https://ui.perfetto.dev or
chrome://tracing).
"""

from __future__ import annotations

import os
import sys
import time


def register_subcommand(subparsers):
    parser = subparsers.add_parser(
        "trace",
        help="Dump/stitch flight-recorder traces into Perfetto-loadable JSON",
        description=__doc__,
    )
    sub = parser.add_subparsers(dest="trace_command")

    dump = sub.add_parser("dump", help="Trigger + stitch a trace dump from a trace dir")
    dump.add_argument(
        "--dir", dest="trace_dir", default=None,
        help="Trace dir (default: $ACCELERATE_TPU_TRACE_DIR) — the --trace_dir "
        "passed to launch / chaos run",
    )
    dump.add_argument("--out", default=None, help="Output JSON path (default: DIR/trace.json)")
    dump.add_argument(
        "--wait", type=float, default=0.0,
        help="Seconds to wait for live processes to serve the touch-file trigger "
        "before stitching (default: stitch immediately)",
    )
    dump.set_defaults(func=trace_dump_command)

    export = sub.add_parser("export", help="Convert span JSONL files to trace-event JSON")
    export.add_argument("inputs", nargs="+", help="spans_*.jsonl files (or trace dirs)")
    export.add_argument("--out", required=True, help="Output trace-event JSON path")
    export.set_defaults(func=trace_export_command)

    report = sub.add_parser("report", help="Summarize a span JSONL file or trace dir")
    report.add_argument("input", help="A spans_*.jsonl file or a trace dir")
    report.set_defaults(func=trace_report_command)

    parser.set_defaults(func=lambda args: parser.print_help() or sys.exit(2))
    return parser


def _collect(path: str):
    from ..telemetry.flight_recorder import collect_trace_dir, read_span_jsonl

    if os.path.isdir(path):
        return collect_trace_dir(path)
    if os.path.isfile(path):
        return read_span_jsonl(path)
    print(f"accelerate-tpu-torch trace: no such file or directory: {path}", file=sys.stderr)
    raise SystemExit(2)


def trace_dump_command(args):
    from ..telemetry.export import write_trace_events
    from ..telemetry.flight_recorder import DUMP_TOUCH_FILE

    trace_dir = args.trace_dir or os.environ.get("ACCELERATE_TPU_TRACE_DIR")
    if not trace_dir:
        print(
            "accelerate-tpu-torch trace dump: no trace dir (--dir or ACCELERATE_TPU_TRACE_DIR)",
            file=sys.stderr,
        )
        raise SystemExit(2)
    if not os.path.isdir(trace_dir):
        print(f"accelerate-tpu-torch trace dump: not a directory: {trace_dir}", file=sys.stderr)
        raise SystemExit(2)
    # Arm the touch file first: any live process polls it at its next step or
    # decode-chunk boundary and writes its own trace_<pid>_NNN.json next to
    # the span streams (the profiler's CAPTURE pattern).
    touch = os.path.join(trace_dir, DUMP_TOUCH_FILE)
    with open(touch, "w"):
        pass
    if args.wait > 0:
        deadline = time.monotonic() + args.wait
        while time.monotonic() < deadline and os.path.exists(touch):
            time.sleep(0.05)
    records = _collect(trace_dir)
    if not records:
        print(
            f"accelerate-tpu-torch trace dump: no spans in {trace_dir} yet (touch file left "
            "armed for live processes)",
            file=sys.stderr,
        )
        raise SystemExit(1)
    out = args.out or os.path.join(trace_dir, "trace.json")
    write_trace_events(records, out)
    print(out)
    raise SystemExit(0)


def trace_export_command(args):
    from ..telemetry.export import write_trace_events

    records = []
    for path in args.inputs:
        records.extend(_collect(path))
    if not records:
        print("accelerate-tpu-torch trace export: inputs contain no spans", file=sys.stderr)
        raise SystemExit(1)
    records.sort(key=lambda r: r.get("start_unix", r.get("t_unix", 0.0)))
    write_trace_events(records, args.out)
    print(args.out)
    raise SystemExit(0)


def trace_report_command(args):
    records = _collect(args.input)
    if not records:
        print("accelerate-tpu-torch trace report: no spans", file=sys.stderr)
        raise SystemExit(1)
    by_name = {}
    times = []
    for record in records:
        key = (record.get("kind", "span"), record.get("name", "?"))
        by_name[key] = by_name.get(key, 0) + 1
        times.append(record.get("start_unix", record.get("t_unix", 0.0)))
    trace_ids = sorted({r.get("trace_id") for r in records if r.get("trace_id")})
    pids = sorted({r.get("pid") for r in records})
    print(f"records: {len(records)}  processes: {pids}  trace ids: {trace_ids}")
    print(f"wall-clock extent: {max(times) - min(times):.3f}s")
    for (kind, name), count in sorted(by_name.items()):
        print(f"  {kind:<11} {name:<28} x{count}")
    crashes = [r for r in records if r.get("name") in ("chaos.crash_boundary", "supervisor.child_exit")]
    if crashes:
        print(f"  crash/exit boundaries: {len(crashes)}")
    raise SystemExit(0)
