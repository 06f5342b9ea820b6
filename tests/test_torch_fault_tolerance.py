"""The port's `Supervisor` (`accelerate_tpu_torch/fault_tolerance.py`) and
JAX's, run over the same child scripts. About 15 s: the children are short
Python processes that import nothing heavy.

Each behaviour is a case for both supervisors, and must come out the same:
attempts and exit codes, the restart budget, 143 as final, the crash-loop
and no-progress aborts, the capped backoff, SIGTERM forwarded within the
grace and the hard kill after it, and the attempt spans with the parent id
each attempt's child receives. Then what only the port has: a group of
processes supervised as one unit, and ``launch --max_restarts`` with
``--trace_dir`` stitching the supervisor's spans and the children's parents
into one trace. Exit codes and counts are exact."""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from accelerate_tpu import fault_tolerance as jax_ft
from accelerate_tpu.telemetry import FlightRecorder as JaxFlightRecorder
from accelerate_tpu.telemetry.tracing import Tracer as JaxTracer
from accelerate_tpu_torch import fault_tolerance as port_ft
from accelerate_tpu_torch import launchers
from accelerate_tpu_torch.commands import trace as port_trace
from accelerate_tpu_torch.telemetry import FlightRecorder, collect_trace_dir
from accelerate_tpu_torch.telemetry.tracing import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPERVISORS = {"jax": jax_ft.Supervisor, "port": port_ft.Supervisor}

CRASHY = (
    "import os, sys\n"
    "marker, fail_times = sys.argv[1], int(sys.argv[2])\n"
    "n = int(open(marker).read()) if os.path.exists(marker) else 0\n"
    "open(marker, 'w').write(str(n + 1))\n"
    "sys.exit(1 if n < fail_times else 0)\n"
)
COUNTING = (
    "import os, sys\n"
    "n = int(open(sys.argv[1]).read()) if os.path.exists(sys.argv[1]) else 0\n"
    "open(sys.argv[1], 'w').write(str(n + 1))\n"
)
GRACEFUL = (
    "import signal, sys, time\n"
    "signal.signal(signal.SIGTERM, lambda *a: sys.exit(143))\n"
    "open(sys.argv[1], 'w').close()\n"
    "time.sleep(60)\n"
)
STUBBORN = (
    "import signal, sys, time\n"
    "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
    "open(sys.argv[1], 'w').close()\n"
    "time.sleep(60)\n"
)


@pytest.fixture(params=sorted(SUPERVISORS))
def Supervisor(request):
    return SUPERVISORS[request.param]


def _read(path):
    with open(path) as f:
        return f.read()


def test_restarts_until_success(Supervisor, tmp_path):
    marker = tmp_path / "attempts"
    sup = Supervisor([sys.executable, "-c", CRASHY, str(marker), "2"], max_restarts=5, backoff_seconds=0.01,
                     monitor_interval=0.05)
    assert sup.run() == 0
    assert sup.restart_count == 2 and _read(marker) == "3"


def test_respects_the_budget(Supervisor, tmp_path):
    marker = tmp_path / "attempts"
    sup = Supervisor([sys.executable, "-c", CRASHY, str(marker), "99"], max_restarts=2, backoff_seconds=0.01,
                     monitor_interval=0.05)
    assert sup.run() == 1
    assert _read(marker) == "3"


def test_preemption_exit_is_final(Supervisor):
    sup = Supervisor([sys.executable, "-c", "raise SystemExit(143)"], max_restarts=5, monitor_interval=0.05)
    assert sup.run() == port_ft.PREEMPTED_EXIT_CODE == jax_ft.PREEMPTED_EXIT_CODE
    assert sup.restart_count == 0


CRASH_LOOPS = {
    # (the child's exit, Supervisor keywords, crash loop detected, restarts)
    "fast_identical": ("raise SystemExit(7)", dict(max_restarts=50, crash_loop_min_uptime=30.0), True, 2),
    "alternating_codes": ("raise SystemExit(7 if n % 2 == 0 else 8)", dict(max_restarts=5, crash_loop_min_uptime=30.0),
                          False, 5),
    "slow_failures": ("raise SystemExit(7)", dict(max_restarts=4, crash_loop_min_uptime=0.0), False, 4),
    "disabled": ("raise SystemExit(7)", dict(max_restarts=6, crash_loop_threshold=0, crash_loop_min_uptime=30.0),
                 False, 6),
}


@pytest.mark.parametrize("case", sorted(CRASH_LOOPS))
def test_crash_loop_detection(Supervisor, tmp_path, case):
    """Identical fast crashes stop after the threshold (7, two restarts);
    alternating codes, slow failures and a disabled detector spend the
    budget instead."""
    body, kwargs, detected, restarts = CRASH_LOOPS[case]
    kwargs = {"crash_loop_threshold": 3, **kwargs}
    marker = tmp_path / "n"
    sup = Supervisor([sys.executable, "-c", COUNTING + body + "\n", str(marker)], backoff_seconds=0.01,
                     max_backoff_seconds=0.05, monitor_interval=0.05, **kwargs)
    code = sup.run()
    assert code in (7, 8)
    assert sup.crash_loop_detected is detected and sup.restart_count == restarts
    assert sup.crash_loop_reason == ("fast_identical_exits" if detected else None)


def test_no_forward_progress_aborts(Supervisor, tmp_path):
    marker = tmp_path / "n"
    sup = Supervisor([sys.executable, "-c", COUNTING + "raise SystemExit(10 + (n % 2))\n", str(marker)],
                     max_restarts=50, backoff_seconds=0.01, max_backoff_seconds=0.05, monitor_interval=0.05,
                     crash_loop_min_uptime=0.0, progress_fn=lambda: None, no_progress_threshold=3)
    sup.run()
    assert sup.crash_loop_detected and sup.crash_loop_reason == "no_forward_progress"
    assert sup.restart_count == 2


def test_progress_resets_the_no_progress_count(Supervisor, tmp_path):
    marker = tmp_path / "n"
    sup = Supervisor([sys.executable, "-c", COUNTING + "raise SystemExit(0 if n >= 5 else 9)\n", str(marker)],
                     max_restarts=10, backoff_seconds=0.01, monitor_interval=0.05, crash_loop_min_uptime=0.0,
                     progress_fn=lambda: _read(marker) if marker.exists() else None, no_progress_threshold=2)
    assert sup.run() == 0
    assert not sup.crash_loop_detected and sup.restart_count == 5


def test_backoff_is_linear_and_capped(Supervisor):
    sup = Supervisor(["true"], max_restarts=1000, backoff_seconds=2.0, max_backoff_seconds=5.0)
    seen = []
    for restarts in (1, 2, 500):
        sup.restart_count = restarts
        seen.append(sup._next_backoff())
    assert seen == [2.0, 4.0, 5.0]


def _sigterm_self_once_ready(paths):
    """SIGTERM this process once every child has installed its handler."""

    def fire():
        deadline = time.perf_counter() + 30
        while not all(os.path.exists(p) for p in paths) and time.perf_counter() < deadline:
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=fire, daemon=True).start()


def test_forwarded_sigterm_ends_within_the_grace(Supervisor, tmp_path):
    ready = str(tmp_path / "ready")
    sup = Supervisor([sys.executable, "-c", GRACEFUL, ready], max_restarts=0, grace_period=30.0, monitor_interval=0.1)
    _sigterm_self_once_ready([ready])
    t0 = time.perf_counter()
    assert sup.run() == 143
    assert time.perf_counter() - t0 < 15.0


def test_grace_expiry_kills_a_stubborn_child(Supervisor, tmp_path):
    ready = str(tmp_path / "ready")
    sup = Supervisor([sys.executable, "-c", STUBBORN, ready], max_restarts=0, grace_period=1.0, monitor_interval=0.1)
    _sigterm_self_once_ready([ready])
    t0 = time.perf_counter()
    assert sup.run() == -signal.SIGKILL
    assert time.perf_counter() - t0 < 20.0


ENV_REPORT = (
    "import json, os, sys\n"
    "marker = sys.argv[1]\n"
    "n = len(os.listdir(marker))\n"
    "keys = ('ACCELERATE_TPU_TRACE_ID', 'ACCELERATE_TPU_TRACE_PARENT', 'ACCELERATE_TPU_TRACE_DIR')\n"
    "json.dump({k: os.environ.get(k) for k in keys}, open(os.path.join(marker, f'{n}.json'), 'w'))\n"
    "sys.exit(1 if n == 0 else 0)\n"
)


def test_attempt_spans_and_injected_parents(tmp_path):
    """With a tracer each attempt is a ``supervisor.attempt`` span ended
    with its exit code, then a ``supervisor.child_exit`` event, and its
    child receives the trace id, the attempt span as parent and the trace
    directory: the same records in both packages."""
    runs = {}
    for name, tracer_cls, recorder_cls in (("jax", JaxTracer, JaxFlightRecorder), ("port", Tracer, FlightRecorder)):
        trace_dir, marker = tmp_path / name / "trace", tmp_path / name / "envs"
        marker.mkdir(parents=True)
        tracer = tracer_cls(recorder=recorder_cls(log_dir=str(trace_dir)), trace_id=f"trace-{name}",
                            category="supervisor")
        sup = SUPERVISORS[name]([sys.executable, "-c", ENV_REPORT, str(marker)], env=dict(os.environ),
                                max_restarts=2, backoff_seconds=0.01, monitor_interval=0.05, tracer=tracer)
        assert sup.run() == 0
        records = collect_trace_dir(str(trace_dir))
        spans = [r for r in records if r.get("name") == "supervisor.attempt" and r.get("kind") == "span"]
        exits = [r for r in records if r.get("name") == "supervisor.child_exit"]
        envs = [json.loads(_read(marker / f"{i}.json")) for i in range(2)]
        assert [e["ACCELERATE_TPU_TRACE_PARENT"] for e in envs] == [s["span_id"] for s in spans]
        assert {e["ACCELERATE_TPU_TRACE_ID"] for e in envs} == {f"trace-{name}"}
        assert {e["ACCELERATE_TPU_TRACE_DIR"] for e in envs} == {str(trace_dir)}
        runs[name] = ([(s["attrs"]["attempt"], s["attrs"]["exit_code"], s["trace_id"]) for s in spans],
                      [(e["attrs"]["attempt"], e["attrs"]["exit_code"]) for e in exits])
    assert runs["port"][0] == [(1, 1, "trace-port"), (2, 0, "trace-port")]
    assert [a[:2] for a in runs["port"][0]] == [a[:2] for a in runs["jax"][0]]
    assert runs["port"][1] == runs["jax"][1] == [(1, 1), (2, 0)]


# ------------------------------------------------------------------ the port's groups
GROUP_CHILD = (
    "import os, sys, time\n"
    "rank, marker = os.environ['RANK'], sys.argv[1]\n"
    "path = os.path.join(marker, rank)\n"
    "n = int(open(path).read()) if os.path.exists(path) else 0\n"
    "open(path, 'w').write(str(n + 1))\n"
    "open(os.path.join(marker, f'port{rank}_{n}'), 'w').write(os.environ['MASTER_PORT'])\n"
    "sys.exit(4 if (rank == '1' and n == 0) else 0)\n"
)


def test_a_group_is_restarted_as_one_unit(tmp_path, monkeypatch):
    """``num_processes=2``: rank 1 fails on the first attempt, so both ranks
    run again, on a fresh port; the second attempt succeeds."""
    monkeypatch.setattr(launchers, "GRACE_S", 0.5)
    sup = port_ft.Supervisor([sys.executable, "-c", GROUP_CHILD, str(tmp_path)], env=dict(os.environ),
                             max_restarts=3, backoff_seconds=0.01, monitor_interval=0.05, num_processes=2)
    assert sup.run() == 0
    assert sup.restart_count == 1
    assert (_read(tmp_path / "0"), _read(tmp_path / "1")) == ("2", "2")
    assert _read(tmp_path / "port0_0") == _read(tmp_path / "port1_0") != _read(tmp_path / "port0_1")


def test_sigterm_reaches_every_rank_of_a_group(tmp_path):
    ready = [str(tmp_path / f"ready{r}") for r in range(2)]
    child = GRACEFUL.replace("open(sys.argv[1], 'w')", "open(sys.argv[1] + __import__('os').environ['RANK'], 'w')")
    sup = port_ft.Supervisor([sys.executable, "-c", child, str(tmp_path / "ready")], max_restarts=3, grace_period=30.0,
                             monitor_interval=0.1, num_processes=2)
    _sigterm_self_once_ready(ready)
    t0 = time.perf_counter()
    assert sup.run() == 143
    assert sup.restart_count == 0 and time.perf_counter() - t0 < 15.0
    assert [p.returncode for p in sup._child.procs] == [143, 143]


def test_launch_max_restarts_stitches_one_trace(tmp_path):
    """``launch --max_restarts 2 --trace_dir D`` of a script that fails once:
    exit 0 after 2 attempts; D holds the supervisor's 2 attempt spans under
    one trace id, each child got its attempt as parent, and ``trace export``
    writes them as one trace."""
    marker, trace_dir = tmp_path / "envs", tmp_path / "trace"
    marker.mkdir()
    script = tmp_path / "child.py"
    script.write_text(ENV_REPORT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    env.pop("ACCELERATE_TPU_TRACE_ID", None)
    cli = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli"]
    result = subprocess.run([*cli, "launch", "--cpu", "--max_restarts", "2", "--restart_backoff", "0.01",
                             "--trace_dir", str(trace_dir), str(script), str(marker)],
                            capture_output=True, text=True, timeout=120, env=env)
    assert result.returncode == 0, result.stdout + result.stderr
    records = collect_trace_dir(str(trace_dir))
    spans = [r for r in records if r.get("name") == "supervisor.attempt" and r.get("kind") == "span"]
    assert [(s["attrs"]["attempt"], s["attrs"]["exit_code"]) for s in spans] == [(1, 1), (2, 0)]
    envs = [json.loads(_read(marker / f"{i}.json")) for i in range(2)]
    assert [e["ACCELERATE_TPU_TRACE_PARENT"] for e in envs] == [s["span_id"] for s in spans]
    assert {e["ACCELERATE_TPU_TRACE_ID"] for e in envs} == {s["trace_id"] for s in spans} and len(spans) == 2
    out = tmp_path / "trace.json"
    with pytest.raises(SystemExit) as done:
        port_trace.trace_export_command(argparse.Namespace(inputs=[str(trace_dir)], out=str(out)))
    assert done.value.code == 0
    events = json.loads(_read(out))["traceEvents"]
    assert sum(1 for e in events if e.get("name") == "supervisor.attempt" and e.get("ph") == "X") == 2
