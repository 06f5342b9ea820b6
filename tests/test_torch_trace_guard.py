"""The port's `TraceGuard` (`accelerate_tpu_torch.analysis.trace_guard`):
the counterpart of each test in `tests/test_trace_guard.py`. In eager torch
its recompile ledger counts kernel builds (`ops._build`), keyed by the
source's name; they are made here by a stand-in ``nvcc`` on the PATH that
writes an empty library, so `build()` runs its real path. Its transfer
ledger counts host syncs on a CUDA device, which this machine has none of:
the sync-debug bookkeeping (arming, `allow_sync`, the "log" mode's captured
warnings, restoring the mode after an exception, naming the line) is driven
through a stand-in for `torch.cuda`'s sync-debug calls that raises or warns
as torch does. `tests/test_torch_cuda.py` holds the real thing on the card."""

import os
import stat
import threading
import warnings

import numpy as np
import pytest
import torch

import accelerate_tpu_torch as port
from accelerate_tpu_torch.analysis import TraceGuard, TraceGuardViolation, allow_sync
from accelerate_tpu_torch.analysis import trace_guard as tg
from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama_model
from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.serving import ContinuousBatcher, Request
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.test_utils.analysis_fixtures import assert_compiles, trace_guard  # noqa: F401

torch.set_num_threads(2)
pytestmark = pytest.mark.analysis

SYNC_MESSAGE = "called a synchronizing CUDA operation"
_CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def reset_state():
    AcceleratorState._reset_state()
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()
    assert not tg._ARMED_GUARDS and not tg._SYNC_GUARDS  # every guard disarmed


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A csrc directory of our own and an ``nvcc`` that writes an empty
    library: `edit(name)` changes a source, so its next `build` compiles."""
    bindir, csrc = tmp_path / "bin", tmp_path / "csrc"
    bindir.mkdir()
    csrc.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text('#!/bin/sh\nout=""\nwhile [ $# -gt 0 ]; do\n  if [ "$1" = "-o" ]; then out="$2"; shift; fi\n'
                    '  shift\ndone\necho "ptxas info    : fake"\n: > "$out"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    versions = {}

    def edit(name):
        versions[name] = versions.get(name, 0) + 1
        (csrc / f"{name}.cu").write_text(f"// version {versions[name]}\n")

    return edit


class FakeSyncDebug:
    """`torch.cuda`'s sync-debug calls on a machine without CUDA: a sync
    (`sync()`) raises in mode 2 ("error") and warns in mode 1 ("warn"), with
    torch's message, as `torch.cuda.set_sync_debug_mode` makes a real sync
    do."""

    LEVELS = {"default": 0, "warn": 1, "error": 2}

    def __init__(self, monkeypatch):
        self.mode = 0
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self._set)

    def _set(self, mode):
        self.mode = self.LEVELS.get(mode, mode)

    def sync(self):
        if self.mode == 2:
            raise RuntimeError(SYNC_MESSAGE)
        if self.mode == 1:
            warnings.warn(SYNC_MESSAGE, UserWarning)
        return 1.0


@pytest.fixture
def fake_sync(monkeypatch):
    return FakeSyncDebug(monkeypatch)


def _line_of(fn, text):
    """file:line of the first line of `fn`'s source holding `text`."""
    import inspect

    lines, start = inspect.getsourcelines(fn)
    offset = next(i for i, line in enumerate(lines) if text in line)
    return f"{inspect.getsourcefile(fn)}:{start + offset}"


# ------------------------------------------------------------------ serving
def test_serving_steady_state_is_clean(trace_guard):
    torch.manual_seed(0)
    engine = ContinuousBatcher(create_llama_model(LlamaConfig(**_CFG), device="cpu"), num_slots=2, max_length=64,
                               chunk_size=4, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(3):
        engine.submit(Request(i, rng.integers(1, 128, (5,)), max_new_tokens=12))
    engine.run()
    for i in range(10, 13):
        engine.submit(Request(i, rng.integers(1, 128, (6,)), max_new_tokens=12))
    guard = trace_guard(name="serving-steady")
    engine.trace_guard = guard
    steps = 0
    with guard:
        while engine.pending and steps < 25:
            engine.step()
            steps += 1
    assert steps >= 3
    assert_compiles(guard, exactly=0)
    assert {r.finish_reason for r in engine.results.values()} <= {"eos", "length"}


# ----------------------------------------------------------------- training
def _accelerator_and_batches(n_batches=6, **kwargs):
    torch.manual_seed(0)
    accelerator = port.Accelerator(cpu=True, **kwargs)
    model = create_llama_model(LlamaConfig(**_CFG), device="cpu")
    ids = np.random.default_rng(0).integers(0, 128, (2 * n_batches, 16))
    loader = port.SimpleDataLoader([{"input_ids": row} for row in ids], port.BatchSampler(range(len(ids)), 2))
    pmodel, _, loader = accelerator.prepare(model, torch.optim.SGD(model.parameters(), lr=0.05), loader)
    return accelerator, pmodel, list(loader)


def test_train_step_steady_state_is_clean(trace_guard):
    accelerator, _, batches = _accelerator_and_batches()
    step_fn = accelerator.train_step()
    step_fn(batches[0])
    guard = trace_guard(name="train-steady")
    with guard:
        for batch in batches[1:4]:
            step_fn(batch)
    assert guard.steps == 0  # fixture guards are armed by hand, not per call
    assert_compiles(guard, exactly=0)


def test_accelerator_analyze_wraps_train_step(fake_nvcc):
    """analyze=True: steady steps pass; a step that builds a kernel in steady
    state raises TraceGuardViolation naming the source."""
    accelerator, pmodel, batches = _accelerator_and_batches(analyze=True)
    assert accelerator.trace_guard is not None
    step_fn = accelerator.train_step()
    for batch in batches[:5]:  # warmup allowance (2) + 3 guarded steady steps
        step_fn(batch)
    guard = accelerator.trace_guard
    assert guard.steps == 3 and guard.total_recompiles == 0 and guard.host_transfers == 0

    loss = pmodel.loss

    def loss_that_builds(*args, **kwargs):
        fake_nvcc("fused_loss")
        _build.build(["fused_loss"])  # an edited source rebuilds: a steady-state compile
        return loss(*args, **kwargs)

    pmodel.loss = loss_that_builds
    step_fn = accelerator.train_step(loss_fn=loss_that_builds)
    with pytest.raises(TraceGuardViolation) as excinfo:
        for batch in batches:
            step_fn(batch)
    assert "fused_loss" in str(excinfo.value) and excinfo.value.report.total_recompiles >= 1


# ------------------------------------------------------------ guard mechanics
def test_unstable_loop_is_caught_and_named(fake_nvcc):
    """An edited source rebuilds at every call: the guard names it with its
    build count (the name is the source's own, with no prefix)."""

    def unstable_step():
        fake_nvcc("unstable_step")
        return _build.build(["unstable_step"])

    unstable_step()  # warmup: one build
    with pytest.raises(TraceGuardViolation) as excinfo:
        with TraceGuard(name="unstable"):
            for _ in range(2):
                unstable_step()
    msg = str(excinfo.value)
    assert "unstable_step" in msg and "recompiled" in msg
    assert excinfo.value.report.compiles.get("unstable_step") == 2


def test_a_library_on_disk_builds_nothing(fake_nvcc):
    fake_nvcc("stable")
    assert _build.build(["stable"]) != {}
    guard = TraceGuard(name="stable")
    with guard:
        assert _build.build(["stable"]) == {}
    assert guard.total_recompiles == 0


def test_record_mode_counts_without_raising(fake_nvcc):
    guard = TraceGuard(on_violation="record", name="record-mode")
    with guard:
        for name in ("a", "b"):
            fake_nvcc(name)
            _build.build([name])
    assert guard.total_recompiles == 2 and guard.compiles == {"a": 1, "b": 1}
    report = guard.report()
    assert report.backend_compiles == guard.backend_compiles == 2  # JAX's name, the sum of the named builds
    assert report.summary() == "recompiled: a x1, b x1"


def test_wrap_warmup_allowance(fake_nvcc):
    built = []

    def step(rebuild):
        if rebuild:
            fake_nvcc("wrapped")
            built.append(_build.build(["wrapped"]))
        return len(built)

    guard = TraceGuard(name="wrapped")
    wrapped = guard.wrap(step, warmup=1)
    wrapped(True)  # warmup: a build is allowed
    wrapped(False)
    wrapped(False)
    assert guard.steps == 2 and guard.total_recompiles == 0
    with pytest.raises(TraceGuardViolation):
        wrapped(True)


def test_sync_guard_raises_at_an_unsanctioned_sync_and_names_its_line(fake_sync):
    """"disallow" (the default): a sync inside the window raises there; the
    raising guard turns it into a TraceGuardViolation naming the file:line;
    a sanctioned sync passes; the mode found before is back afterwards."""
    fake_sync.mode = 0

    def step(sanctioned):
        if sanctioned:
            with allow_sync():
                return fake_sync.sync()
        return fake_sync.sync()

    guard = TraceGuard(name="syncs")
    wrapped = guard.wrap(step, warmup=0)
    assert wrapped(True) == 1.0
    assert fake_sync.mode == 0
    with pytest.raises(TraceGuardViolation) as excinfo:
        wrapped(False)
    site = _line_of(FakeSyncDebug.sync, "raise RuntimeError")
    assert site in str(excinfo.value) and SYNC_MESSAGE in str(excinfo.value)
    assert guard.transfer_violations == [f"{site}: {SYNC_MESSAGE}"]
    assert TraceGuard.is_transfer_violation(excinfo.value)
    assert fake_sync.mode == 0  # restored though an exception left the window


def test_log_mode_records_each_sync_with_its_line_and_passes_other_warnings(fake_sync):
    fake_sync.mode = 1  # a user's own setting, put back on exit
    guard = TraceGuard(transfer_guard="log", on_violation="record", name="log")
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with guard:
            assert fake_sync.mode == 1
            fake_sync.sync()
            fake_sync.sync()
            warnings.warn("an unrelated warning")
            with allow_sync():
                assert fake_sync.mode == 0
                fake_sync.sync()
    assert fake_sync.mode == 1
    assert len(guard.transfer_violations) == 2 and all(SYNC_MESSAGE in v for v in guard.transfer_violations)
    assert all(__file__ in v for v in guard.transfer_violations)
    assert [str(w.message) for w in shown] == ["an unrelated warning"]


def test_sync_mode_is_set_from_what_is_open_whatever_order_threads_close(fake_sync):
    """The mode is process-wide: it is set from the armed guards and the open
    `allow_sync` blocks, never restored from a value a block saved. A block
    on another thread that outlives the guard armed when it opened leaves
    the mode found before the guard; a guard armed while such a block is
    open starts lifted and takes hold when the block closes."""
    fake_sync.mode = 1  # a user's own setting
    opened, release, closed = threading.Event(), threading.Event(), threading.Event()

    def sanctioned():
        with allow_sync():
            opened.set()
            release.wait(10)
        closed.set()

    guard = TraceGuard(name="a")
    with guard:
        worker = threading.Thread(target=sanctioned)
        worker.start()
        assert opened.wait(10) and fake_sync.mode == 0  # lifted for every thread
    assert fake_sync.mode == 1
    release.set()
    assert closed.wait(10)
    worker.join()
    assert fake_sync.mode == 1  # not the guard's "error", which would raise at every later sync

    opened.clear(), release.clear(), closed.clear()
    worker = threading.Thread(target=sanctioned)
    worker.start()
    assert opened.wait(10)
    with guard:
        assert fake_sync.mode == 0
        release.set()
        assert closed.wait(10)
        assert fake_sync.mode == 2
    worker.join()
    assert fake_sync.mode == 1 and tg._SYNC_STATE["allowed"] == 0


def test_the_cpu_has_no_sync_to_catch():
    """Without CUDA the guard leaves the sync-debug mode alone (torch has
    none to set) and its transfer ledger stays empty."""
    guard = TraceGuard(name="cpu")
    with guard:
        assert float(torch.ones(()).sum().item()) == 1.0
        assert not tg._SYNC_GUARDS
    assert guard.host_transfers == 0


def test_observe_classifies_and_records():
    guard = TraceGuard(on_violation="record")
    assert not guard.observe(ValueError("unrelated"))
    try:
        raise RuntimeError(f"CUDA error: {SYNC_MESSAGE}")
    except RuntimeError as exc:
        fake = exc
    assert guard.observe(fake) and guard.observe(fake)  # the same exception counts once
    assert guard.host_transfers == 1 and __file__ in guard.transfer_violations[0]


def test_disarmed_guard_ignores_outside_compiles(fake_nvcc):
    guard = TraceGuard(on_violation="raise", name="disarmed")
    wrapped = guard.wrap(lambda: None, warmup=1)
    listeners = len(_build.BUILD_LISTENERS)
    for _ in range(5):
        wrapped()
    assert guard not in tg._ARMED_GUARDS and len(_build.BUILD_LISTENERS) == max(listeners, 1)
    fake_nvcc("elsewhere")
    _build.build(["elsewhere"])  # no guard armed
    assert guard.total_recompiles == 0
    wrapped()


def test_wrapped_transfer_violation_counted_once(fake_sync):
    guard = TraceGuard(on_violation="record", name="once")
    wrapped = guard.wrap(fake_sync.sync, warmup=0)
    with pytest.raises(RuntimeError) as excinfo:
        wrapped()
    assert TraceGuard.is_transfer_violation(excinfo.value) and not isinstance(excinfo.value, TraceGuardViolation)
    assert guard.host_transfers == 1, guard.transfer_violations


def test_guard_restores_state_when_nested_and_reentered(fake_sync):
    outer, inner = TraceGuard(name="outer"), TraceGuard(transfer_guard="log", on_violation="record", name="inner")
    with outer:
        with outer:  # re-entrant: one arming
            assert fake_sync.mode == 2 and tg._SYNC_GUARDS == [outer]
            with inner:
                assert fake_sync.mode == 1
            assert fake_sync.mode == 2
        assert fake_sync.mode == 2
    assert fake_sync.mode == 0 and not tg._ARMED_GUARDS
    with pytest.raises(ValueError):
        TraceGuard(transfer_guard="sometimes")


def test_engine_reads_the_device_back_only_where_sanctioned(fake_sync, monkeypatch):
    """Every tensor-to-host read made as a card would make it (each one a
    sync there): a warm engine's steps, plain and speculative, read back only
    inside `allow_sync` — the chunk's one readback and the insert's first
    token. Before the repair, each insert also read its first and last
    position back (`CausalPrograms.prefill`), two unsanctioned syncs that
    JAX's insert, taking them as operands, does not make."""
    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu", "numpy"):
        orig = getattr(torch.Tensor, name)

        def reading(self, *a, _orig=orig, **kw):
            fake_sync.sync()
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, reading)
    torch.manual_seed(0)
    model = create_llama_model(LlamaConfig(**_CFG), device="cpu")
    rng = np.random.default_rng(0)
    for extra in ({}, dict(speculative=True, draft_tokens=3)):
        engine = ContinuousBatcher(model, num_slots=2, max_length=64, chunk_size=4, page_size=8, device="cpu",
                                   **extra)
        engine.run([Request(i, rng.integers(1, 128, (9,)), max_new_tokens=6) for i in range(2)])
        guard = TraceGuard(transfer_guard="log", on_violation="record", name="reads")
        engine.trace_guard = guard
        with guard:
            engine.run([Request(i, rng.integers(1, 128, (int(rng.integers(3, 20)),)), max_new_tokens=6)
                        for i in range(10, 14)])
        assert all(r.finish_reason == "length" for r in engine.results.values())
        assert guard.host_transfers == 0, guard.transfer_violations
    # the same read outside the engine's sanctioned places is caught
    with TraceGuard(transfer_guard="log", on_violation="record") as guard:
        int(torch.ones((), dtype=torch.int64))
    assert guard.host_transfers == 1
