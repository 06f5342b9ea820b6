"""The port's telemetry (`accelerate_tpu_torch.telemetry`) held to JAX's
(`accelerate_tpu.telemetry`): the counterpart of each test in
`tests/test_telemetry.py` that applies to the port (metrics semantics,
thread safety under a concurrent engine, the step timeline and goodput on a
fake clock, the profiler manager against a stub backend and the real
`torch.profiler` one on the CPU, the exporters, the instrumented engine and
`Accelerator`), and parity with JAX on the same numpy inputs: byte-equal
Prometheus text, equal snapshots and quantiles, the same accept/reject
decisions of the host-scalar gate, equal goodput on one fake clock, the
engines' tokens, instrument values, histogram counts and per-request span
events, and `Accelerator(analyze=True)`'s step counts."""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import accelerate_tpu.telemetry as jt
import accelerate_tpu_torch as port
import accelerate_tpu_torch.telemetry as pt
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import SimpleDataLoader as JaxLoader
from accelerate_tpu.data_loader import BatchSampler as JaxBatchSampler
from accelerate_tpu.models import llama as jax_llama
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig, create_llama_model as jax_create
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher, Request as JaxRequest
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu_torch.analysis import TraceGuard
from accelerate_tpu_torch.models import llama as port_llama
from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama_model, llama_state_dict_from_flax
from accelerate_tpu_torch.serving import ContinuousBatcher, Request
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.telemetry import (
    DEFAULT_LATENCY_BUCKETS,
    FlightRecorder,
    MetricsHTTPServer,
    MetricsRegistry,
    ProfilerManager,
    StepTimeline,
    TrackerBridge,
    Tracer,
    log_spaced_buckets,
    parse_prometheus_text,
    to_prometheus_text,
    write_jsonl_snapshot,
    write_prometheus_textfile,
)
from accelerate_tpu_torch.test_utils.analysis_fixtures import assert_compiles, trace_guard  # noqa: F401

torch.set_num_threads(2)
pytestmark = pytest.mark.telemetry

VOCAB = 128
_CFG = dict(
    vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64, rope_theta=10000.0,
)


@pytest.fixture(scope="module")
def models():
    """(JAX Model bundle, port model) on the same random weights."""
    jmodel = jax_create(JaxLlamaConfig(**_CFG), seq_len=32)
    cfg = LlamaConfig(**_CFG)
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jmodel.params), cfg))
    return jmodel, model


@pytest.fixture
def one_torch_thread():
    """The bit-for-bit loss comparisons run torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_state():
    for cls in (AcceleratorState, GradientState, JaxAcceleratorState, JaxGradientState, JaxPartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, JaxAcceleratorState, JaxGradientState, JaxPartialState):
        cls._reset_state()


# ------------------------------------------------------------------ histogram
def test_log_spaced_buckets_shape():
    buckets = log_spaced_buckets(1e-4, 100.0, per_decade=4)
    assert buckets == tuple(sorted(set(buckets)))
    assert buckets[0] == pytest.approx(1e-4)
    assert buckets[-1] >= 100.0
    assert len(buckets) == 25
    assert DEFAULT_LATENCY_BUCKETS == buckets == jt.DEFAULT_LATENCY_BUCKETS
    assert log_spaced_buckets(1e-4, 90.0, per_decade=4)[-1] >= 90.0


def test_histogram_bucket_property_every_observation_lands_once():
    rng = np.random.default_rng(0)
    for trial in range(5):
        hist = MetricsRegistry().histogram(f"h{trial}", buckets=log_spaced_buckets(1e-3, 10.0, 3))
        values = np.exp(rng.normal(-2.0, 2.5, size=500))  # spills both ends
        for v in values:
            hist.observe(float(v))
        counts = hist.bucket_counts()
        assert sum(counts) == hist.count == 500
        assert hist.sum == pytest.approx(float(values.sum()), rel=1e-9)


def test_histogram_quantile_within_bucket_resolution():
    rng = np.random.default_rng(1)
    width = 10 ** (1 / 4)
    hist = MetricsRegistry().histogram("lat", buckets=log_spaced_buckets(1e-4, 100.0, 4))
    values = np.exp(rng.normal(np.log(0.05), 1.0, size=2000))
    for v in values:
        hist.observe(float(v))
    for q in (0.1, 0.5, 0.9, 0.99):
        true, est = float(np.percentile(values, q * 100)), hist.quantile(q)
        assert est / true < width * 1.01 and true / est < width * 1.01, (q, est, true)


def test_histogram_quantile_edge_cases():
    hist = MetricsRegistry().histogram("edge", buckets=(1.0, 10.0))
    assert hist.quantile(0.5) is None
    hist.observe(1e9)
    assert hist.quantile(0.99) == 10.0
    with pytest.raises(ValueError):
        hist.quantile(1.5)


# The host-scalar gate: every torch.Tensor (0-d and CPU included) is refused,
# as JAX's gate refuses a jax array; np.float64 passes (it subclasses float).
GATE_VALUES = {
    "int": 3, "float": 0.5, "np_float64": np.float64(0.5), "np_float32": np.float32(0.5),
    "bool": True, "np_int64": np.int64(3), "np_array": np.ones(3), "str": "0.5", "none": None,
    "tensor_0d": torch.tensor(0.5), "tensor_1d": torch.ones(3), "tensor_int": torch.tensor(3),
    "jax_array": jnp.ones(()),
}


@pytest.mark.parametrize("key", sorted(GATE_VALUES))
def test_check_scalar_accepts_and_rejects_what_jax_does(key):
    value = GATE_VALUES[key]

    def outcome(check):
        try:
            return check(value)
        except TypeError:
            return "TypeError"

    got, want = outcome(pt.metrics._check_scalar), outcome(jt.metrics._check_scalar)
    assert got == want
    if key.startswith("tensor"):
        assert got == "TypeError"
    if key == "np_float64":
        assert got == 0.5


def test_instruments_reject_device_like_values():
    registry = MetricsRegistry()
    with pytest.raises(TypeError):
        registry.counter("c").inc(np.ones(3))
    with pytest.raises(TypeError):
        registry.histogram("h").observe(torch.tensor(0.5))
    with pytest.raises(TypeError):
        registry.gauge("g").set(True)
    registry.histogram("h").observe(np.float64(0.5))


# ------------------------------------------------------------------- registry
def test_registry_get_or_create_identity_and_kind_conflicts():
    registry = MetricsRegistry()
    a = registry.counter("requests_total", labels={"reason": "eos"})
    b = registry.counter("requests_total", labels={"reason": "eos"})
    c = registry.counter("requests_total", labels={"reason": "length"})
    assert a is b and a is not c
    with pytest.raises(ValueError):
        registry.gauge("requests_total", labels={"reason": "eos"})
    with pytest.raises(ValueError):
        registry.counter("bad name!")
    a.inc()
    assert registry.value("requests_total", {"reason": "eos"}) == 1
    assert registry.value("requests_total", {"reason": "length"}) == 0


def test_registry_thread_safety_exact_counts():
    registry = MetricsRegistry()
    counter, hist = registry.counter("hits_total"), registry.histogram("lat_seconds")

    def hammer():
        for i in range(5000):
            counter.inc()
            hist.observe(0.001 * (1 + i % 7))

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter.value == hist.count == sum(hist.bucket_counts()) == 8 * 5000


def _populate(registry, seed=0):
    """A seeded observation sequence: labelled counters, gauges, histograms on
    the default and on custom buckets, and a hostile label value."""
    rng = np.random.default_rng(seed)
    for reason in ("eos", "length", 'quo"te\\n'):
        registry.counter("reqs_total", help="requests", labels={"reason": reason}).inc(int(rng.integers(0, 50)))
    registry.gauge("queue_depth", help="waiting").set(float(rng.integers(0, 9)))
    registry.gauge("ratio").set(float(rng.random()))
    ttft = registry.histogram("ttft_seconds", help="ttft")
    custom = registry.histogram("tokens", buckets=(1.0, 2.0, 3.0, 4.0))
    for v in np.exp(rng.normal(-3.0, 2.0, size=300)):
        ttft.observe(float(v))
    for v in rng.integers(1, 6, size=50):
        custom.observe(float(v))
    return registry


def test_same_observations_give_jax_s_prometheus_text_snapshot_and_quantiles():
    ours, theirs = _populate(MetricsRegistry()), _populate(jt.MetricsRegistry())
    text = to_prometheus_text(ours)
    assert text.encode() == jt.to_prometheus_text(theirs).encode()
    assert ours.snapshot() == theirs.snapshot()
    for name in ("ttft_seconds", "tokens"):
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert ours.get(name).quantile(q) == theirs.get(name).quantile(q)
    assert parse_prometheus_text(text) == jt.parse_prometheus_text(text)


# ------------------------------------------------------------------- timeline
def _drive_timeline(timeline, clock, guard):
    for _ in range(3):
        with timeline.phase("data_wait"):
            clock["t"] += 0.5
        with timeline.phase("dispatch"):
            clock["t"] += 1.5
        timeline.step_done()
    timeline.charge("checkpoint", 4.0)
    timeline.record_phase("block", 0.25)
    timeline.observe_trace_guard(guard)
    clock["t"] += 2.0


def test_step_timeline_phases_and_goodput_arithmetic():
    clock = {"t": 100.0}
    registry = MetricsRegistry()
    timeline = StepTimeline(registry, prefix="train", clock=lambda: clock["t"])
    for _ in range(3):
        with timeline.phase("data_wait"):
            clock["t"] += 0.5
        with timeline.phase("dispatch"):
            clock["t"] += 1.5
        timeline.step_done()
    timeline.charge("checkpoint", 4.0)
    clock["t"] += 2.0
    report = timeline.goodput()
    assert report["steps"] == 3 and report["total_s"] == pytest.approx(8.0)
    assert report["productive_s"] == pytest.approx(6.0)
    assert report["lost_s"] == {"checkpoint": 4.0}
    assert report["unaccounted_s"] == pytest.approx(0.0)
    assert report["goodput"] == pytest.approx(0.75)
    assert registry.value("train_steps_total") == 3
    assert registry.get("train_step_seconds").count == 3
    assert registry.value("train_lost_seconds_total", {"cause": "checkpoint"}) == pytest.approx(4.0)
    assert registry.value("train_goodput_ratio") == pytest.approx(0.75)
    timeline.reset()
    assert timeline.goodput()["steps"] == 0
    with pytest.raises(ValueError):
        timeline.charge("checkpoint", -1.0)


def test_fake_clock_gives_jax_s_goodput():
    """One fake clock sequence through both timelines: equal `goodput()`,
    equal registries."""
    from accelerate_tpu.analysis import TraceGuard as JaxTraceGuard

    guards = (TraceGuard(on_violation="record"), JaxTraceGuard(on_violation="record"))
    for guard in guards:
        guard.compiles["fused_step"] = 2
        guard.transfer_violations.append("a sync")
    reports, registries = [], []
    for module, guard in zip((pt, jt), guards):
        clock = {"t": 100.0}
        registry = module.MetricsRegistry()
        timeline = module.StepTimeline(registry, prefix="train", clock=lambda: clock["t"])
        _drive_timeline(timeline, clock, guard)
        reports.append(timeline.goodput())
        registries.append(registry.snapshot())
    assert reports[0] == reports[1]
    assert registries[0] == registries[1]


def test_step_timeline_folds_trace_guard_ledger():
    registry = MetricsRegistry()
    timeline = StepTimeline(registry, prefix="train")
    guard = TraceGuard(on_violation="record", name="t")
    guard.compiles["flash_attention"] = 2
    guard.transfer_violations.append("serving.py:1: called a synchronizing CUDA operation")
    timeline.observe_trace_guard(guard)
    timeline.observe_trace_guard(guard)  # idempotent folding
    assert registry.value("train_recompiles_total") == 2
    assert registry.value("train_guarded_transfers_total") == 1


def test_timeline_record_phase_does_not_reopen_step():
    clock = {"t": 0.0}
    timeline = StepTimeline(MetricsRegistry(), prefix="t", clock=lambda: clock["t"])
    with timeline.phase("dispatch"):
        clock["t"] += 1.0
    timeline.step_done()
    timeline.record_phase("block", 0.5)
    assert timeline._step_open_since is None
    clock["t"] += 0.5
    report = timeline.goodput()
    assert report["phase_s"]["block"] == pytest.approx(0.5)
    assert report["productive_s"] == pytest.approx(1.0)


def test_sampled_block_waits_on_nothing_on_the_cpu_and_records_its_time():
    registry = MetricsRegistry()
    timeline = StepTimeline(registry, prefix="train", sample_block_every=2)
    for _ in range(4):
        with timeline.phase("dispatch"):
            out = {"loss": torch.ones(()), "aux": [torch.zeros(2)]}
        timeline.step_done(out)
    assert registry.get("train_block_seconds").count == 2  # every 2nd step
    assert timeline.goodput()["phase_s"]["block"] >= 0.0


def test_build_listener_charges_compile_time():
    from accelerate_tpu_torch.ops import _build

    timeline = StepTimeline(MetricsRegistry(), prefix="train")
    before = list(_build.BUILD_LISTENERS)
    try:
        timeline.attach_compile_listener()
        timeline.attach_compile_listener()  # once
        assert len(_build.BUILD_LISTENERS) == len(before) + 1
        _build._notify_built("flash_attention", 2.5)
    finally:
        _build.BUILD_LISTENERS[:] = before
    assert timeline.goodput()["lost_s"] == {"compile": 2.5}


# ------------------------------------------------------------------- profiler
class _StubProfiler:
    def __init__(self):
        self.calls, self.tracing = [], False

    def start_trace(self, log_dir):
        assert not self.tracing
        self.tracing = True
        self.calls.append(("start", log_dir))

    def stop_trace(self):
        assert self.tracing
        self.tracing = False
        self.calls.append(("stop",))

    def save_device_memory_profile(self, path):
        with open(path, "w") as f:
            f.write("snapshot")
        self.calls.append(("memory", path))


def test_profiler_touch_file_trigger_and_fixed_window(tmp_path):
    clock = {"t": 0.0}
    stub = _StubProfiler()
    manager = ProfilerManager(log_dir=str(tmp_path), capture_seconds=5.0, poll_every=1, backend=stub,
                              clock=lambda: clock["t"])
    assert manager.enabled and not manager.poll()
    (tmp_path / "CAPTURE").touch()
    assert manager.poll() is True and not (tmp_path / "CAPTURE").exists() and stub.tracing
    clock["t"] += 4.0
    assert manager.poll() is True
    clock["t"] += 2.0
    assert manager.poll() is False and not stub.tracing
    assert manager.registry.value("profiler_captures_total") == 1
    assert manager.registry.value("profiler_active") == 0


def test_profiler_signal_latch_trace_scope_and_memory(tmp_path):
    stub = _StubProfiler()
    manager = ProfilerManager(log_dir=str(tmp_path), poll_every=1, backend=stub)
    manager.request_capture()
    assert manager.poll() is True
    assert manager.stop() is True and manager.stop() is False
    with manager.trace(subdir="scoped") as target:
        assert target.endswith("scoped") and stub.tracing
    assert not stub.tracing
    path = manager.save_memory_snapshot()
    assert path is not None and ("memory", path) in stub.calls
    disabled = ProfilerManager(log_dir=None, backend=stub)
    assert disabled.start() is None and disabled.poll() is False and disabled.save_memory_snapshot() is None


def test_profiler_from_env_reads_launch_protocol(tmp_path, monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    manager = ProfilerManager.from_env(install_signal=False, backend=_StubProfiler())
    assert manager.enabled and manager.log_dir == str(tmp_path / "prof")
    monkeypatch.delenv("ACCELERATE_TPU_PROFILE_DIR")
    assert not ProfilerManager.from_env(backend=_StubProfiler()).enabled


def test_torch_profiler_backend_writes_a_chrome_trace_and_refuses_a_cpu_memory_snapshot(tmp_path):
    """The real backend on the CPU: a window writes torch.profiler's Chrome
    trace with the ops that ran; without CUDA the memory snapshot raises and
    writes nothing."""
    manager = ProfilerManager(log_dir=str(tmp_path))
    with manager.trace(subdir="window") as target:
        torch.ones(8, 8) @ torch.ones(8, 8)
    (trace,) = [n for n in os.listdir(target) if n.endswith(".json")]
    events = json.loads(open(os.path.join(target, trace)).read())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    with pytest.raises(RuntimeError, match="CUDA"):
        manager.save_memory_snapshot(str(tmp_path / "memory.pickle"))
    assert not (tmp_path / "memory.pickle").exists()


# ------------------------------------------------------------------- exporters
def _small_registry():
    registry = MetricsRegistry()
    registry.counter("reqs_total", help="requests", labels={"reason": "eos"}).inc(3)
    registry.counter("reqs_total", labels={"reason": "length"}).inc(7)
    registry.gauge("queue_depth", help="waiting").set(2)
    hist = registry.histogram("ttft_seconds", help="ttft", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        hist.observe(v)
    return registry


def test_prometheus_text_round_trip():
    parsed = parse_prometheus_text(to_prometheus_text(_small_registry()))
    assert parsed["reqs_total"]["type"] == "counter"
    assert parsed["reqs_total"]["samples"][(("reason", "eos"),)] == 3
    assert parsed["queue_depth"]["samples"][()] == 2
    buckets = parsed["ttft_seconds_bucket"]["samples"]
    assert [buckets[(("le", le),)] for le in ("0.01", "0.1", "1", "+Inf")] == [1, 3, 4, 5]
    assert parsed["ttft_seconds_sum"]["samples"][()] == pytest.approx(5.605)


def test_prometheus_label_escapes_round_trip():
    registry = MetricsRegistry()
    nasty = ['a"b', "line\nbreak", r"back\slash", r"literal\n", "comma,inside", "\\"]
    for i, value in enumerate(nasty):
        registry.counter("odd_total", labels={"v": value}).inc(i + 1)
    samples = parse_prometheus_text(to_prometheus_text(registry))["odd_total"]["samples"]
    for i, value in enumerate(nasty):
        assert samples[(("v", value),)] == i + 1, value


def test_prometheus_textfile_and_jsonl(tmp_path):
    registry = _small_registry()
    prom = tmp_path / "metrics.prom"
    write_prometheus_textfile(registry, str(prom))
    assert prom.read_text() == to_prometheus_text(registry)
    jsonl = tmp_path / "snapshots.jsonl"
    write_jsonl_snapshot(registry, str(jsonl), step=1)
    registry.gauge("queue_depth").set(9)
    write_jsonl_snapshot(registry, str(jsonl), step=2, run="r")
    lines = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert len(lines) == 2 and lines[1]["step"] == 2 and lines[1]["run"] == "r"
    assert [m["value"] for m in lines[1]["metrics"] if m["name"] == "queue_depth"] == [9]


def test_metrics_http_server_serves_prometheus_text():
    registry = _small_registry()
    server = MetricsHTTPServer(registry, port=0)
    try:
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            body = resp.read().decode()
        assert body == to_prometheus_text(registry)
        assert parse_prometheus_text(body)["reqs_total"]["samples"][(("reason", "eos"),)] == 3
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{server.host}:{server.port}/nope", timeout=10)
    finally:
        server.close()


def test_tracker_bridge_flattens_through_the_port_s_accelerator_log(tmp_path):
    """The bridge publishes through the port's `Accelerator.log` into its JSON
    tracker: counters and gauges as scalars, histograms as count/sum/p50/p99."""
    accelerator = port.Accelerator(cpu=True, log_with="json", project_dir=str(tmp_path))
    accelerator.init_trackers("telemetry")
    accelerator.telemetry.counter("reqs_total", labels={"reason": "eos"}).inc(3)
    hist = accelerator.telemetry.histogram("ttft_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5):
        hist.observe(v)
    values = TrackerBridge(accelerator).publish(step=7)
    accelerator.end_training()
    assert values["telemetry/reqs_total.reason=eos"] == 3
    assert values["telemetry/ttft_seconds.count"] == 3 and "telemetry/ttft_seconds.p50" in values
    logged = [json.loads(line) for path in tmp_path.rglob("*.jsonl") for line in path.read_text().splitlines()]
    assert any(rec.get("step") == 7 and rec.get("telemetry/reqs_total.reason=eos") == 3 for rec in logged), logged
    with pytest.raises(ValueError):
        TrackerBridge(object())


# ------------------------------------------------------- the engine (parity)
def _mixed(seed, n, prompt_lo=3, prompt_hi=20, new_lo=2, new_hi=10, shared=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, VOCAB, (shared,))
    reqs = []
    for i in range(n):
        prompt = rng.integers(1, VOCAB, (int(rng.integers(prompt_lo, prompt_hi)),))
        if shared and i % 2 == 0:
            prompt = np.concatenate([prefix, prompt])
        reqs.append((i, prompt.astype(np.int32), int(rng.integers(new_lo, new_hi))))
    return reqs


def _instrument_values(registry, module):
    """{(name, labels): value} of counters and gauges, {(name, labels):
    count} of histograms (their sums are host timings)."""
    values, counts = {}, {}
    for inst in registry.instruments():
        key = (inst.name, inst.labels)
        if isinstance(inst, module.Histogram):
            counts[key] = inst.count
        else:
            values[key] = inst.value
    return values, counts


def _span_events(recorder):
    per_request, names = {}, []
    for record in recorder.records():
        names.append(record["name"])
        if record["name"] == "serve.request":
            attrs = record["attrs"]
            per_request[attrs["request_id"]] = (
                [e["name"] for e in record.get("events", [])], attrs["finish_reason"], attrs["tokens"],
            )
    return per_request, sorted(set(names))


@pytest.mark.parametrize("extra", [{}, dict(speculative=True, draft_tokens=3), dict(num_pages=11)],
                         ids=["plain", "speculative", "evicting"])
def test_engine_matches_jax_s_tokens_instruments_and_spans(models, extra):
    jmodel, model = models
    reqs = _mixed(3, 6 if "num_pages" not in extra else 10, shared=20)
    kw = dict(num_slots=2, max_length=64, chunk_size=4, page_size=8, **extra)
    jrec, prec = jt.FlightRecorder(), FlightRecorder()
    jengine = JaxBatcher(jmodel, registry=jt.MetricsRegistry(), tracer=jt.Tracer(recorder=jrec), **kw)
    pengine = ContinuousBatcher(model, device="cpu", registry=MetricsRegistry(), tracer=Tracer(recorder=prec), **kw)
    jout = jengine.run([JaxRequest(i, p, max_new_tokens=n) for i, p, n in reqs])
    pout = pengine.run([Request(i, p, max_new_tokens=n) for i, p, n in reqs])
    assert {r: list(map(int, t)) for r, t in pout.items()} == {r: list(map(int, t)) for r, t in jout.items()}
    assert _instrument_values(pengine.metrics, pt) == _instrument_values(jengine.metrics, jt)
    assert _span_events(prec) == _span_events(jrec)
    chunks = [r for r in prec.records() if r["name"] == "serve.decode_chunk"]
    assert len(chunks) == pengine.stats["chunks"] and all("slots" in r["attrs"] for r in chunks)
    assert pengine.stats["prefix_cache"]["hits"] > 0
    evictions = pengine.metrics.value("serving_prefix_cache_evictions_total")
    assert evictions == pengine.pool.evictions and (evictions > 0) == ("num_pages" in extra)
    jstats = {k: v for k, v in jengine.stats.items() if k not in ("tp", "queue_peak", "attention_impl")}
    assert {k: v for k, v in pengine.stats.items() if k != "attention_impl"} == jstats


def test_registry_under_concurrent_serving_submit_drain(models):
    _, model = models
    engine = ContinuousBatcher(model, num_slots=2, max_length=64, chunk_size=4, device="cpu")
    rng = np.random.default_rng(2)
    n = 10
    prompts = [rng.integers(1, VOCAB, (int(rng.integers(3, 9)),)) for _ in range(n)]

    def producer():
        for i, p in enumerate(prompts):
            engine.submit(Request(i, p, max_new_tokens=6))
            time.sleep(0.002)

    thread = threading.Thread(target=producer)
    thread.start()
    deadline = time.monotonic() + 60
    while (thread.is_alive() or engine.pending) and time.monotonic() < deadline:
        engine.step()
    thread.join()
    registry = engine.metrics
    assert all(r.finished for r in engine.results.values())
    assert registry.value("serving_requests_submitted_total") == n
    assert sum(engine.stats["finish_reasons"].values()) == n == engine.stats["finish_reasons"]["length"]
    assert registry.get("serving_ttft_seconds").count == n
    assert registry.value("serving_slot_utilization") == 0.0


def test_instrumented_serving_steady_state_holds_0_0_and_exports(models, trace_guard):
    """With full telemetry on, a warm engine builds nothing and syncs
    nothing it may not (on the CPU: the ledger's bookkeeping), and a
    Prometheus scrape of its histograms and gauges round-trips with the
    engine's own counts."""
    _, model = models
    engine = ContinuousBatcher(model, num_slots=2, max_length=64, chunk_size=4, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(3):
        engine.submit(Request(i, rng.integers(1, VOCAB, (5,)), max_new_tokens=8))
    engine.run()
    guard = trace_guard(name="telemetry-serving")
    engine.trace_guard = guard
    for i in range(10, 14):
        engine.submit(Request(i, rng.integers(1, VOCAB, (6,)), max_new_tokens=8))
    with guard:
        engine.run()
    assert_compiles(guard, exactly=0)
    registry = engine.metrics
    inter = registry.get("serving_inter_token_seconds")
    assert registry.get("serving_ttft_seconds").count == 7 and inter.count > 0
    parsed = parse_prometheus_text(to_prometheus_text(registry))
    assert parsed["serving_ttft_seconds_count"]["samples"][()] == 7
    assert parsed["serving_inter_token_seconds_count"]["samples"][()] == inter.count
    assert parsed["serving_queue_depth"]["samples"][()] == 0
    assert parsed["serving_slots_in_use"]["samples"][()] == 0
    assert sum(parsed["serving_requests_finished_total"]["samples"].values()) == 7
    assert engine.stats["inserts"] == 7 and engine.stats["finish_reasons"]["error"] == 0


# ------------------------------------------------------- the Accelerator
SEQ = 16


def _rows(n, seed=0):
    ids = np.random.default_rng(seed).integers(0, 512, (n, SEQ)).astype(np.int32)
    return [{"input_ids": ids[i]} for i in range(n)]


@pytest.fixture(scope="module")
def tiny_weights():
    jcfg = jax_llama.llama_tiny()
    jmodel = jax_llama.create_llama_model(jcfg, seq_len=SEQ)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    cfg = port_llama.LlamaConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(port_llama.LlamaConfig)})
    return jmodel, params, cfg


def _port_model(tiny_weights):
    _, params, cfg = tiny_weights
    model = port_llama.create_llama_model(cfg, device="cpu")
    model.load_state_dict(port_llama.llama_state_dict_from_flax(params, cfg))
    return model


def _adamw(model):
    return torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def test_accelerator_owns_telemetry_and_instruments_train_step_as_jax_s(tiny_weights, one_torch_thread):
    """`Accelerator(analyze=True)` on both sides: 4 steps each count 4 in
    `train_steps_total` and `train_dispatch_seconds`, the guard saw 2 steady
    steps and nothing else, and the port's losses equal those of its bare
    fused step (no telemetry) bit for bit."""
    data = _rows(16)
    jaxacc = JaxAccelerator(analyze=True)
    tx = optax.adamw(1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    _, _, jloader = jaxacc.prepare(dataclasses.replace(tiny_weights[0]), tx,
                                   JaxLoader(data, JaxBatchSampler(range(len(data)), 4)))
    jstep = jaxacc.train_step(max_grad_norm=1.0)
    for batch in jloader:
        jstep(batch)

    accelerator = port.Accelerator(cpu=True, analyze=True)
    assert accelerator.telemetry is accelerator.timeline.registry
    assert not accelerator.profiler.enabled and accelerator.trace_guard is not None
    model = _port_model(tiny_weights)
    _, _, loader = accelerator.prepare(model, _adamw(model), port.SimpleDataLoader(data, port.BatchSampler(range(16), 4)))
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    assert step_fn.trace_guard is accelerator.trace_guard and step_fn.model is accelerator._models[0]
    losses = [float(step_fn(batch)) for batch in loader]
    for registry in (accelerator.telemetry, jaxacc.telemetry):
        assert registry.value("train_steps_total") == 4
        assert registry.get("train_dispatch_seconds").count == 4
    assert accelerator.timeline.goodput()["steps"] == jaxacc.timeline.goodput()["steps"] == 4
    for guard in (accelerator.trace_guard, jaxacc.trace_guard):
        assert guard.steps == 2 and guard.total_recompiles == 0 and guard.host_transfers == 0

    AcceleratorState._reset_state()
    GradientState._reset_state()
    bare_acc = port.Accelerator(cpu=True)
    model = _port_model(tiny_weights)
    pmodel, popt, loader = bare_acc.prepare(model, _adamw(model), port.SimpleDataLoader(data, port.BatchSampler(range(16), 4)))
    from accelerate_tpu_torch.train_step import FusedTrainStep

    bare = FusedTrainStep(pmodel, popt, max_grad_norm=1.0, gradient_state=bare_acc.gradient_state)
    assert [float(bare(batch)) for batch in loader] == losses


def test_checkpoint_spans_charges_and_counters(tiny_weights, tmp_path):
    recorder = FlightRecorder()
    accelerator = port.Accelerator(cpu=True, tracer=Tracer(recorder=recorder))
    model = _port_model(tiny_weights)
    accelerator.prepare(model, _adamw(model))
    path = accelerator.save_state(str(tmp_path / "ckpt"))
    accelerator.load_state(path)
    registry = accelerator.telemetry
    assert registry.value("checkpoint_saves_total") == 1 and registry.value("checkpoint_loads_total") == 1
    assert registry.get("checkpoint_save_seconds").count == 1
    lost = accelerator.timeline.goodput()["lost_s"]
    assert set(lost) == {"checkpoint", "restart"} and all(v > 0 for v in lost.values())
    names = [r["name"] for r in recorder.records()]
    assert names == ["checkpoint.save", "checkpoint.load"]
    with pytest.raises(ValueError):
        accelerator.save_state()  # no output_dir: failed, charged, not counted
    assert registry.value("checkpoint_saves_total") == 1
    assert "error" in recorder.records()[-1]["attrs"]


def test_profile_and_memory_profile_on_the_cpu(tmp_path):
    accelerator = port.Accelerator(cpu=True, project_dir=str(tmp_path))
    with accelerator.profile():
        torch.ones(4) + 1
    (capture,) = os.listdir(tmp_path / "profile")
    assert any(n.endswith(".json") for n in os.listdir(tmp_path / "profile" / capture))
    assert accelerator.telemetry.value("profiler_captures_total") == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        accelerator.save_memory_profile(str(tmp_path / "memory.pickle"))


def test_fp16_skipped_steps_drop_jax_s_events(tiny_weights, one_torch_thread):
    """Under fp16 a skipped fused step drops a ``train.step_skipped`` event
    with the new loss scale, as JAX's does: the same events, with the same
    scales, on the same weights and batches (an initial scale of 2^24
    overflows fp16 in the first steps)."""
    from accelerate_tpu.utils.dataclasses import GradScalerKwargs as JaxGradScalerKwargs
    from accelerate_tpu_torch import GradScalerKwargs

    data, kwargs = _rows(16), dict(init_scale=2.0 ** 24, growth_interval=3)
    jrec, prec = jt.FlightRecorder(), FlightRecorder()
    jaxacc = JaxAccelerator(mixed_precision="fp16", kwargs_handlers=[JaxGradScalerKwargs(**kwargs)],
                            tracer=jt.Tracer(recorder=jrec))
    tx = optax.adamw(1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    _, _, jloader = jaxacc.prepare(dataclasses.replace(tiny_weights[0]), tx,
                                   JaxLoader(data, JaxBatchSampler(range(16), 4)))
    jstep = jaxacc.train_step(max_grad_norm=1.0)
    for batch in jloader:
        jstep(batch)
    accelerator = port.Accelerator(mixed_precision="fp16", cpu=True, kwargs_handlers=[GradScalerKwargs(**kwargs)],
                                   tracer=Tracer(recorder=prec))
    model = _port_model(tiny_weights)
    _, popt, loader = accelerator.prepare(model, _adamw(model), port.SimpleDataLoader(data, port.BatchSampler(range(16), 4)))
    step_fn = accelerator.train_step(max_grad_norm=1.0)
    skipped = []
    for batch in loader:
        step_fn(batch)
        skipped.append(popt.step_was_skipped)

    def skips(recorder):
        return [r["attrs"]["loss_scale"] for r in recorder.records() if r["name"] == "train.step_skipped"]

    assert skips(prec) == skips(jrec) and len(skips(prec)) == sum(skipped) > 0
    assert [r["name"] for r in prec.records()].count("train.step") == 4
