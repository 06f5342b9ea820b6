"""Step-timeline and goodput accounting: where each second of wall clock went
(the port of `accelerate_tpu/telemetry/timeline.py`).

On an async backend a training/serving loop has three very different kinds of
time that one `elapsed / steps` number conflates:

  - **data_wait** — the host blocked on the input pipeline (`next(loader)`);
  - **dispatch** — the host enqueued the step's kernels (returns long before
    the device finishes: cheap when pipelined, a hang when the device stalls);
  - **block** — a sampled synchronize of the CUDA devices that hold a step's
    outputs, the only honest measure of device compute (never every step: a
    per-step sync serializes dispatch against the device). On the CPU there
    is nothing to wait for; the (near-zero) time is still recorded.

`StepTimeline` splits per-step wall clock into those phases (latency
histograms per phase, one shared log-spaced bucket layout) and keeps the
**goodput ledger**: time *lost* to overheads a production run must budget —
checkpoint saves (`Accelerator.save_state` charges them), restarts
(`load_state`), and compiles — in the eager port, the kernel builds
(`ops._build`), charged by duration through the build listeners, or counted
from an `analysis.TraceGuard` ledger. ``goodput()`` then answers: of the
wall clock this run burned, what fraction was productive steps, what was
charged to which overhead, and how much is unaccounted (the signature of an
opaque hang).

All timing is host-side `perf_counter` arithmetic — the timeline never touches
device values except the explicitly-sampled block, a sanctioned sync for an
armed `TraceGuard`.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Callable, Dict, Optional

from .metrics import MetricsRegistry

logger = logging.getLogger(__name__)

#: Step phases with first-class histograms (charge() accepts any cause).
PHASES = ("data_wait", "dispatch", "block")

#: Well-known goodput loss causes (an arbitrary cause string is also accepted;
#: these are the ones the framework charges itself).
LOSS_CAUSES = ("checkpoint", "restart", "compile", "recompile")


class StepTimeline:
    """Per-step phase timing + a goodput ledger, publishing into a registry.

    Typical training wiring (what `Accelerator.train_step` instruments)::

        timeline = StepTimeline(registry, prefix="train", sample_block_every=32)
        for _ in range(steps):
            with timeline.phase("data_wait"):
                batch = next(stream)
            with timeline.phase("dispatch"):
                out = step_fn(batch)
            timeline.step_done(out)   # sampled block_until_ready on `out`
        report = timeline.goodput()

    ``sample_block_every=K`` synchronizes on every K-th step's outputs (K=0
    never blocks): the sampled block time estimates the device-compute floor without
    serializing the steady-state pipeline.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        prefix: str = "step",
        sample_block_every: int = 0,
        clock: Callable[[], float] = time.perf_counter,
        tracer=None,
        unaccounted_warn_s: Optional[float] = 60.0,
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.prefix = prefix
        self.sample_block_every = int(sample_block_every)
        self._clock = clock
        # The unaccounted-time alarm: `goodput()` reports `unaccounted_s` but
        # a number nobody reads is not a diagnostic. When a window's residual
        # exceeds this threshold, goodput() WARNS (once per window) and drops
        # a span event through `tracer` — the same "missing time" definition
        # the hang watchdog dumps on, so the ledger and the watchdog agree.
        self.tracer = tracer
        self.unaccounted_warn_s = unaccounted_warn_s
        self._unaccounted_warned = False
        self._lock = threading.Lock()
        self.steps = 0
        self._phase_totals: Dict[str, float] = {}
        self._productive_s = 0.0
        self._lost: Dict[str, float] = {}
        self._step_open_since: Optional[float] = None
        self._start = clock()
        self._steps_counter = self.registry.counter(
            f"{prefix}_steps_total", help="completed steps observed by the timeline"
        )
        self._step_hist = self.registry.histogram(
            f"{prefix}_step_seconds", help="wall-clock per step (all phases)"
        )
        self._phase_hists = {
            name: self.registry.histogram(
                f"{prefix}_{name}_seconds", help=f"per-step {name} wall-clock"
            )
            for name in PHASES
        }
        self._goodput_gauge = self.registry.gauge(
            f"{prefix}_goodput_ratio", help="productive step time / total wall clock"
        )
        self._monitoring_hooked = False

    # ------------------------------------------------------------------ phases
    @contextlib.contextmanager
    def phase(self, name: str):
        """Time one phase of the current step. The first phase of a step opens
        the step; `step_done()` closes it."""
        t0 = self._clock()
        with self._lock:
            if self._step_open_since is None:
                self._step_open_since = t0
        try:
            yield
        finally:
            dt = self._clock() - t0
            with self._lock:
                self._phase_totals[name] = self._phase_totals.get(name, 0.0) + dt
            hist = self._phase_hists.get(name)
            if hist is None:
                hist = self.registry.histogram(f"{self.prefix}_{name}_seconds")
                self._phase_hists[name] = hist
            hist.observe(dt)

    def record_phase(self, name: str, seconds: float):
        """Attribute already-measured wall clock to a phase WITHOUT opening a
        step — for work that runs after `step_done()` (e.g. a validation-mode
        readback): using `phase()` there would reopen the step and skew the
        next step's wall clock."""
        seconds = float(seconds)
        if seconds < 0:
            raise ValueError("cannot record negative time")
        with self._lock:
            self._phase_totals[name] = self._phase_totals.get(name, 0.0) + seconds
        hist = self._phase_hists.get(name)
        if hist is None:
            hist = self.registry.histogram(f"{self.prefix}_{name}_seconds")
            self._phase_hists[name] = hist
        hist.observe(seconds)

    def step_done(self, outputs=None) -> float:
        """Close the current step; returns its wall-clock seconds. On sampled
        steps (every `sample_block_every`-th, when `outputs` is given) blocks
        until `outputs` are ready and records the wait as the "block" phase —
        the sampled device-compute attribution."""
        with self._lock:
            opened = self._step_open_since
            self._step_open_since = None
            self.steps += 1
            sampled = (
                outputs is not None
                and self.sample_block_every > 0
                and self.steps % self.sample_block_every == 0
            )
        if sampled:
            t0 = self._clock()
            _block_until_ready(outputs)
            dt = self._clock() - t0
            with self._lock:
                self._phase_totals["block"] = self._phase_totals.get("block", 0.0) + dt
            self._phase_hists["block"].observe(dt)
        now = self._clock()
        step_s = (now - opened) if opened is not None else 0.0
        with self._lock:
            self._productive_s += step_s
        self._steps_counter.inc()
        self._step_hist.observe(step_s)
        return step_s

    # ------------------------------------------------------------------ ledger
    def charge(self, cause: str, seconds: float):
        """Charge lost wall-clock to a cause (checkpoint/restart/compile/...).
        Lost time is *overhead the run paid that was not a training/serving
        step*: it lowers goodput without touching the phase histograms."""
        seconds = float(seconds)
        if seconds < 0:
            raise ValueError("cannot charge negative time")
        with self._lock:
            self._lost[cause] = self._lost.get(cause, 0.0) + seconds
        self.registry.counter(
            f"{self.prefix}_lost_seconds_total",
            help="wall-clock charged to overhead causes",
            labels={"cause": cause},
        ).inc(seconds)

    def attach_compile_listener(self):
        """Charge every kernel build's DURATION to the "compile" cause through
        `ops._build`'s build listeners (the events `TraceGuard` counts too).
        Warmup builds are lost time as well, so all of them are charged here;
        steady-state builds are the subset `observe_trace_guard` counts."""
        if self._monitoring_hooked:
            return
        from ..ops import _build

        _build.add_build_listener(lambda name, seconds: self.charge("compile", seconds))
        self._monitoring_hooked = True

    def observe_trace_guard(self, guard):
        """Fold an `analysis.TraceGuard` ledger into the registry: steady-state
        recompile and guarded-transfer COUNTS become counters (the guard has no
        durations — `attach_compile_listener` carries the time side)."""
        report = guard.report()
        recompiles = self.registry.counter(
            f"{self.prefix}_recompiles_total",
            help="steady-state recompiles observed by TraceGuard",
        )
        delta = report.total_recompiles - recompiles.value
        if delta > 0:
            recompiles.inc(delta)
        transfers = self.registry.counter(
            f"{self.prefix}_guarded_transfers_total",
            help="guarded host transfers observed by TraceGuard",
        )
        delta = report.host_transfers - transfers.value
        if delta > 0:
            transfers.inc(delta)

    # ------------------------------------------------------------------ report
    def goodput(self) -> dict:
        """The accounting answer: total wall clock since construction/reset,
        productive step seconds, per-cause lost seconds, and the residual
        `unaccounted_s` (host work between steps — or an opaque stall). The
        `goodput` ratio is productive/total; `accounted` is
        (productive+lost)/total — a hang shows as a LOW accounted fraction."""
        now = self._clock()
        with self._lock:
            total = max(now - self._start, 1e-9)
            productive = self._productive_s
            lost = dict(self._lost)
            phases = dict(self._phase_totals)
            steps = self.steps
        lost_total = sum(lost.values())
        goodput = productive / total
        self._goodput_gauge.set(goodput)
        unaccounted = max(total - productive - lost_total, 0.0)
        if (
            self.unaccounted_warn_s is not None
            and unaccounted >= self.unaccounted_warn_s
            and not self._unaccounted_warned
        ):
            # Once per accounting window: the hang signature surfacing at
            # RUNTIME instead of waiting for a postmortem to read the ledger.
            self._unaccounted_warned = True
            logger.warning(
                "goodput: %.1fs of wall clock is unaccounted (total %.1fs, productive "
                "%.1fs, lost %.1fs) — the host is stalling outside the instrumented "
                "loop (device init, a slow input pipeline, or an opaque hang)",
                unaccounted, total, productive, lost_total,
            )
            if self.tracer is not None:
                self.tracer.event(
                    "goodput.unaccounted", category="goodput",
                    unaccounted_s=round(unaccounted, 3), total_s=round(total, 3),
                    productive_s=round(productive, 3), lost_s=round(lost_total, 3),
                )
        return {
            "total_s": round(total, 6),
            "steps": steps,
            "productive_s": round(productive, 6),
            "lost_s": {k: round(v, 6) for k, v in sorted(lost.items())},
            "lost_total_s": round(lost_total, 6),
            "unaccounted_s": round(unaccounted, 6),
            "phase_s": {k: round(v, 6) for k, v in sorted(phases.items())},
            "goodput": round(goodput, 6),
            "accounted": round(min((productive + lost_total) / total, 1.0), 6),
        }

    def reset(self):
        """Restart the accounting window (registry instruments keep their
        lifetime totals; the goodput ledger starts fresh)."""
        with self._lock:
            self._start = self._clock()
            self.steps = 0
            self._phase_totals = {}
            self._productive_s = 0.0
            self._lost = {}
            self._step_open_since = None
            self._unaccounted_warned = False


def _cuda_devices(tree, found: set):
    """Collect the CUDA devices of the tensors in `tree` (dicts, lists and
    tuples of them), without importing torch."""
    if isinstance(tree, dict):
        for value in tree.values():
            _cuda_devices(value, found)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            _cuda_devices(value, found)
    else:
        device = getattr(tree, "device", None)
        if getattr(device, "type", None) == "cuda":
            found.add(device)


def _block_until_ready(outputs):
    """Wait until the CUDA devices holding `outputs` finished their work: the
    counterpart of `jax.block_until_ready`, sanctioned for an armed
    `TraceGuard`. Tensors on the CPU are ready already: nothing waits."""
    devices: set = set()
    _cuda_devices(outputs, devices)
    if not devices:
        return
    import torch

    from ..analysis.trace_guard import allow_sync

    with allow_sync():
        for device in devices:
            torch.cuda.synchronize(device)
