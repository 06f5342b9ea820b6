"""The port's request-scoped tracing (`accelerate_tpu_torch.telemetry`:
`Tracer`, `Span`, `FlightRecorder`, `HangWatchdog`, the Perfetto export) held
to JAX's: the counterpart of each test in `tests/test_tracing.py` that
applies to the port (span lifecycle and nesting, the host-value gate, the
ring, the streamed JSONL and its torn tail, the trace-event export, the
touch-file dump, the hang watchdog on a fake clock, the env protocol, the
engine's request spans, the goodput alarm), the exit hooks taken out again,
the kernel-build listener's ``compile`` spans, and parity with JAX: the
same span tree gives equal trace events once the ids are normalised, and
the attribute gate accepts and rejects what JAX's does. The Supervisor, the
chaos runner and the trace CLI are not ported yet (ROADMAP A)."""

import json
import os
import signal

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import accelerate_tpu.telemetry as jt
from accelerate_tpu.telemetry import tracing as jtracing
from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama_model
from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.serving import ContinuousBatcher, Request
from accelerate_tpu_torch.telemetry import (
    FlightRecorder,
    StepTimeline,
    Tracer,
    collect_trace_dir,
    read_span_jsonl,
    to_trace_events,
)
from accelerate_tpu_torch.telemetry import tracing as ptracing
from accelerate_tpu_torch.telemetry.flight_recorder import DUMP_TOUCH_FILE
from accelerate_tpu_torch.telemetry.tracing import TRACE_DIR_ENV, TRACE_ID_ENV, TRACE_PARENT_ENV

torch.set_num_threads(2)
pytestmark = pytest.mark.tracing


class FakeClock:
    """A monotonic clock that moves only when told to."""

    def __init__(self, start=1000.0):
        self.t = float(start)

    def monotonic(self):
        return self.t

    perf_counter = monotonic

    def sleep(self, seconds):
        self.t += float(seconds)


# ------------------------------------------------------------------ span semantics
def test_span_lifecycle_and_nesting():
    recorder = FlightRecorder()
    tracer = Tracer(recorder=recorder, category="test")
    with tracer.span("outer", a=1) as outer:
        assert tracer.current_span is outer
        outer.event("milestone", note="hi")
        with tracer.span("inner") as inner:
            assert inner.parent_id == outer.span_id
        assert tracer.current_span is outer
    assert tracer.current_span is None
    records = recorder.records()
    assert [r["name"] for r in records] == ["inner", "outer"]
    assert records[1]["attrs"] == {"a": 1} and records[1]["events"][0]["name"] == "milestone"
    assert records[1]["trace_id"] == records[0]["trace_id"] == tracer.trace_id
    span = tracer.start_span("solo")
    span.end()
    span.end()
    assert [r["name"] for r in recorder.records()].count("solo") == 1


def test_span_error_annotation_and_propagation():
    tracer = Tracer(recorder=FlightRecorder())
    with pytest.raises(RuntimeError):
        with tracer.span("doomed"):
            raise RuntimeError("boom")
    (record,) = tracer.recorder.records()
    assert "boom" in record["attrs"]["error"] and tracer.current_span is None


ATTR_VALUES = {
    "str": "x", "int": 3, "float": 0.5, "bool": True, "none": None, "np_float64": np.float64(0.5),
    "np_int64": np.int64(3), "list": [1, 2], "np_array": np.ones(3), "tensor_0d": torch.tensor(1.0),
    "tensor_cpu": torch.ones(2), "jax_array": jnp.ones(()),
}


@pytest.mark.parametrize("key", sorted(ATTR_VALUES))
def test_attribute_gate_accepts_and_rejects_what_jax_does(key):
    value = ATTR_VALUES[key]

    def outcome(check):
        try:
            return check({"v": value}) == {"v": value}
        except TypeError:
            return "TypeError"

    got = outcome(ptracing._check_attrs)
    assert got == outcome(jtracing._check_attrs)
    if key.startswith("tensor"):
        assert got == "TypeError"


def test_annotation_host_value_gate():
    tracer = Tracer(recorder=FlightRecorder())
    with pytest.raises(TypeError, match="host values"):
        tracer.start_span("bad", payload=torch.ones(3))
    span = tracer.start_span("ok", n=3, f=0.5, s="x", b=True, none=None)
    with pytest.raises(TypeError, match="host values"):
        span.event("bad", arr=torch.tensor(1))
    with pytest.raises(TypeError, match="host values"):
        span.annotate(arr=[1, 2])
    span.end()


# ------------------------------------------------------------------ flight recorder
def test_ring_buffer_eviction_order():
    recorder = FlightRecorder(capacity=4)
    tracer = Tracer(recorder=recorder)
    for i in range(10):
        tracer.start_span("s", idx=i).end()
    assert [r["attrs"]["idx"] for r in recorder.records()] == [6, 7, 8, 9]
    assert recorder.registry.value("trace_spans_recorded_total") == 10
    assert recorder.registry.value("trace_spans_evicted_total") == 6


def test_streamed_jsonl_survives_torn_tail(tmp_path):
    trace_dir = str(tmp_path / "trace")
    tracer = Tracer(recorder=FlightRecorder(log_dir=trace_dir))
    open_span = tracer.start_span("unfinished")
    tracer.start_span("done").end()
    tracer.event("marker", k=1)
    stream = os.path.join(trace_dir, f"spans_{os.getpid()}.jsonl")
    with open(stream, "a") as f:
        f.write('{"kind": "span", "name": "torn')
    records = read_span_jsonl(stream)
    kinds = {(r["kind"], r["name"]) for r in records}
    assert {("span_start", "unfinished"), ("span", "done"), ("event", "marker")} <= kinds
    assert not any(r.get("name") == "torn" for r in records)
    assert collect_trace_dir(trace_dir) == sorted(records, key=lambda r: r.get("start_unix", r.get("t_unix", 0.0)))
    open_span.end()
    tracer.recorder.close()


def test_perfetto_export_schema_and_roundtrip(tmp_path):
    trace_dir = str(tmp_path / "trace")
    recorder = FlightRecorder(log_dir=trace_dir)
    tracer = Tracer(recorder=recorder)
    with tracer.span("parent", kindof="serve") as parent:
        parent.event("instant", x=1)
        with tracer.span("child"):
            pass
    tracer.event("standalone")
    dangling = tracer.start_span("dangling")
    data = json.loads(open(recorder.dump(reason="test")).read())
    assert set(data) == {"traceEvents", "displayTimeUnit"}
    events = data["traceEvents"]
    assert {e["ph"] for e in events} <= {"M", "X", "B", "i"}
    ts = [e["ts"] for e in events if e["ph"] != "M"]
    assert ts == sorted(ts) and all(isinstance(t, int) for t in ts)
    names = {e["name"] for e in events}
    assert {"parent", "child", "instant", "standalone"} <= names and "dangling" not in names
    stitched = to_trace_events(collect_trace_dir(trace_dir))["traceEvents"]
    assert any(e["name"] == "dangling" and e["ph"] == "B" for e in stitched)
    dangling.end()
    recorder.close()


def _normalised(events):
    """Trace events with trace/span/parent ids renamed by first appearance."""
    names = {}
    out = []
    for event in events:
        event = json.loads(json.dumps(event))
        args = event.get("args", {})
        for key in ("trace_id", "span_id", "parent_id"):
            if args.get(key) is not None:
                args[key] = names.setdefault(args[key], f"id{len(names)}")
        out.append(event)
    return out


def test_span_trees_give_jax_s_trace_events(tmp_path):
    """The same span tree (nesting, events, a standalone event, an error, a
    request span outliving its frame) on one fake clock through both tracers:
    the trace events are equal once the ids are normalised, and JAX's
    exporter renders the port's records as the port's does."""
    traces = []
    for module in (ptracing, jtracing):
        clock = FakeClock()
        recorder = (FlightRecorder if module is ptracing else jt.FlightRecorder)()
        tracer = module.Tracer(recorder=recorder, clock=clock.monotonic, category="serve")
        tracer._anchor = 1.7e9  # one wall-clock anchor for both
        request = tracer.start_span("serve.request", request_id=7, prompt_tokens=12)
        request.event("submitted", queue_depth=1)
        clock.sleep(0.25)
        with tracer.activate(request):
            with tracer.span("serve.insert", slot=0) as insert:
                clock.sleep(0.5)
                insert.annotate(bucket=12)
        tracer.event("serve.blast_radius", errored_requests=0)
        try:
            with tracer.span("serve.decode_chunk", slots="0"):
                clock.sleep(1.0)
                raise ValueError("x")
        except ValueError:
            pass
        request.annotate(finish_reason="length", tokens=4).end()
        traces.append(recorder.records())
    ours, theirs = traces
    assert _normalised(to_trace_events(ours)["traceEvents"]) == _normalised(jt.to_trace_events(theirs)["traceEvents"])
    assert to_trace_events(ours) == jt.to_trace_events(ours)


def test_touch_file_dump_trigger(tmp_path):
    trace_dir = str(tmp_path / "trace")
    recorder = FlightRecorder(log_dir=trace_dir, poll_every=2)
    Tracer(recorder=recorder).start_span("work").end()
    touch = os.path.join(trace_dir, DUMP_TOUCH_FILE)
    open(touch, "w").close()
    assert recorder.poll() is False and recorder.poll() is True and not os.path.exists(touch)
    assert len([n for n in os.listdir(trace_dir) if n.startswith("trace_") and n.endswith(".json")]) == 1
    recorder.close()


def test_exit_hooks_install_and_come_out_again(tmp_path):
    """The atexit dump and the chained SIGTERM handler go in with
    `install_exit_hooks` and out with `remove_exit_hooks`, leaving the handler
    that was there before."""
    before = signal.getsignal(signal.SIGTERM)
    recorder = FlightRecorder(log_dir=str(tmp_path / "trace"))
    recorder.install_exit_hooks()
    try:
        assert signal.getsignal(signal.SIGTERM) is not before
        Tracer(recorder=recorder).start_span("work").end()
        recorder._dump_on_exit()
        assert any(n.startswith("trace_") for n in os.listdir(tmp_path / "trace"))
    finally:
        recorder.remove_exit_hooks()
        recorder.remove_exit_hooks()  # idempotent
        recorder.close()
    assert signal.getsignal(signal.SIGTERM) is before


# ------------------------------------------------------------------ hang watchdog
def test_hang_watchdog_fires_on_stalled_fake_step(tmp_path):
    clock = FakeClock()
    trace_dir = str(tmp_path / "trace")
    recorder = FlightRecorder(log_dir=trace_dir, clock=clock.monotonic)
    tracer = Tracer(recorder=recorder, clock=clock.monotonic)
    watchdog = recorder.start_watchdog(deadline_s=30.0, tracer=tracer, clock=clock.monotonic, start_thread=False)
    clock.sleep(100)
    assert watchdog.check_once() is False  # unarmed: warmup is not a stall
    tracer.start_span("train.step", step=0).end()
    recorder.heartbeat()
    clock.sleep(10)
    assert watchdog.check_once() is False
    clock.sleep(25)
    assert watchdog.check_once() is True and watchdog.check_once() is False
    names = {e["name"] for e in json.loads(open(watchdog.last_dump).read())["traceEvents"]}
    assert "hang.detected" in names and "train.step" in names
    stacks = open(watchdog.last_stacks_path).read()
    assert "test_hang_watchdog_fires_on_stalled_fake_step" in stacks
    recorder.heartbeat()
    clock.sleep(31)
    assert watchdog.check_once() is True and watchdog.fired_count == 2
    recorder.close()


def test_watchdog_thread_is_a_daemon_and_stops(tmp_path):
    recorder = FlightRecorder(log_dir=str(tmp_path / "trace"))
    watchdog = recorder.start_watchdog(deadline_s=60.0, poll_interval_s=0.01)
    assert watchdog._thread.daemon and watchdog._thread.is_alive()
    watchdog.stop()
    assert watchdog._thread is None
    recorder.close()


def test_tracer_from_env_reads_protocol(tmp_path, monkeypatch):
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "t"))
    monkeypatch.setenv(TRACE_ID_ENV, "cafecafecafe")
    monkeypatch.setenv(TRACE_PARENT_ENV, "beefbeefbeef")
    tracer = Tracer.from_env()
    assert tracer.trace_id == "cafecafecafe" and tracer.root_parent_id == "beefbeefbeef"
    assert tracer.recorder.log_dir == str(tmp_path / "t")
    span = tracer.start_span("root")
    assert span.parent_id == "beefbeefbeef"
    span.end()
    env = tracer.inject_env({})
    assert env[TRACE_ID_ENV] == "cafecafecafe" and env[TRACE_DIR_ENV] == str(tmp_path / "t")
    assert (TRACE_DIR_ENV, TRACE_ID_ENV, TRACE_PARENT_ENV) == (
        jtracing.TRACE_DIR_ENV, jtracing.TRACE_ID_ENV, jtracing.TRACE_PARENT_ENV)
    tracer.recorder.close()


def test_build_listener_records_a_compile_span_per_source():
    """Each kernel build becomes a ``compile`` span named by its source, as
    long as the build took, and feeds the watchdog."""
    clock = FakeClock()
    recorder = FlightRecorder(clock=clock.monotonic)
    tracer = Tracer(recorder=recorder, clock=clock.monotonic)
    watchdog = recorder.start_watchdog(deadline_s=5.0, clock=clock.monotonic, start_thread=False)
    before = list(_build.BUILD_LISTENERS)
    try:
        tracer.attach_compile_listener()
        tracer.attach_compile_listener()
        assert len(_build.BUILD_LISTENERS) == len(before) + 1
        _build._notify_built("flash_attention", 27.5)
        _build._notify_built("paged_attention", 4.0)
    finally:
        _build.BUILD_LISTENERS[:] = before
    spans = recorder.records()
    assert [(r["name"], r["cat"], r["duration_s"]) for r in spans] == [
        ("flash_attention", "compile", 27.5), ("paged_attention", "compile", 4.0)]
    assert watchdog._last_beat == clock.t  # the build armed the watchdog


# ------------------------------------------------------------------ serving spans
def test_serving_request_lifecycle_spans():
    cfg = LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
    torch.manual_seed(0)
    recorder = FlightRecorder()
    engine = ContinuousBatcher(create_llama_model(cfg, device="cpu"), num_slots=2, max_length=64, chunk_size=4,
                               device="cpu", tracer=Tracer(recorder=recorder, category="serve"))
    rng = np.random.default_rng(0)
    for i in range(4):
        engine.submit(Request(i, rng.integers(1, 128, (6,)), max_new_tokens=5))
    engine.run()
    engine.close()
    records = recorder.records()
    requests = {r["attrs"]["request_id"]: r for r in records if r["name"] == "serve.request"}
    assert sorted(requests) == [0, 1, 2, 3]
    for record in requests.values():
        assert record["attrs"]["finish_reason"] == "length" and record["attrs"]["tokens"] == 5
        assert [e["name"] for e in record["events"]] == ["submitted", "admitted", "first_token"]
        admitted = record["events"][1]["attrs"]
        assert admitted["queue_wait_s"] >= 0 and "pages_reserved" in admitted
    inserts = [r for r in records if r["name"] == "serve.insert"]
    assert len(inserts) == 4 and all(r["parent_id"] in {q["span_id"] for q in requests.values()} for r in inserts)
    chunks = [r for r in records if r["name"] == "serve.decode_chunk"]
    assert len(chunks) == engine.stats["chunks"] and all("slots" in r["attrs"] for r in chunks)
    assert sum(r["attrs"]["tokens_streamed"] for r in chunks) == 4 * 4  # every token after the first


# ------------------------------------------------------------------ goodput alarm
def test_goodput_unaccounted_warning_and_span_event():
    clock = FakeClock()
    tracer = Tracer(recorder=FlightRecorder(), clock=clock.monotonic)
    timeline = StepTimeline(clock=clock.perf_counter, tracer=tracer, unaccounted_warn_s=50.0)
    with timeline.phase("dispatch"):
        clock.sleep(1.0)
    timeline.step_done()
    clock.sleep(100.0)
    report = timeline.goodput()
    assert report["unaccounted_s"] >= 50.0

    def alarms():
        return [r for r in tracer.recorder.records() if r["name"] == "goodput.unaccounted"]

    assert len(alarms()) == 1
    assert alarms()[0]["attrs"]["unaccounted_s"] == pytest.approx(report["unaccounted_s"], abs=0.1)
    timeline.goodput()
    assert len(alarms()) == 1
    timeline.reset()
    clock.sleep(200.0)
    timeline.goodput()
    assert len(alarms()) == 2
