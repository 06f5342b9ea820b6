"""Runtime guard for the port's steady-state discipline (the port of
`accelerate_tpu/analysis/trace_guard.py`, with its API).

`TraceGuard` is a (re-entrant) context manager that, while armed, keeps two
ledgers. JAX's count jit cache misses and implicit transfers; in eager torch
they mean:

  - **recompiles**: kernel builds (`ops._build`, one ``nvcc`` per source,
    the only compile an eager port makes) seen while armed, keyed by the
    source's name (``flash_attention``, ``paged_attention``). A library
    already on disk builds nothing, so a warm step records none.
  - **guarded transfers**: host syncs on a CUDA device outside a sanctioned
    step boundary, caught by `torch.cuda.set_sync_debug_mode` (the
    counterpart of ``jax.transfer_guard``). With ``transfer_guard=
    "disallow"`` (the default) the sync raises at the offending line; with
    ``"log"`` it warns, and the guard records it without raising. Each
    entry names the user frame that made the sync (file:line). A sanctioned
    sync — the places where JAX makes an explicit push (``jnp.asarray``) or
    drain (``np.asarray``/``int()``): the engine's per-chunk state uploads
    and its one readback, the insert's pushes and first-token read, the
    fp16 step's finite check, the timeline's sampled block, the caller's
    loss read — runs inside `allow_sync()`, which lifts the mode for its
    duration. On a machine without CUDA there is no sync to catch and the
    ledger stays empty. Torch calls the mode a prototype that does not yet
    detect every synchronizing operation: it sees the synchronizing copies
    (``.item()``, ``.cpu()``, a pageable host-to-device copy) and stream
    and device synchronizes.

On exit, ``on_violation="raise"`` turns any recorded build into a
`TraceGuardViolation` naming the sources, and an in-flight sync error into
one naming the file:line; ``"record"`` keeps the ledger and lets the
original exception through.

Steady state is the caller's business: arm the guard AFTER warmup.
`TraceGuard.wrap(step_fn, warmup=1)` does that for per-call arming, as
`Accelerator(analyze=True)` uses it around the fused train step.

The sync debug mode is process-wide, so this module keeps its state under
one lock and sets the mode from that state, never from a value saved by a
block that may have outlived its guard: with no guard armed it is the mode
found before the first guard armed (put back when the last one exits, an
exception leaving the window included); while any thread is inside
`allow_sync` it is lifted; else it is the innermost armed guard's. A
sanctioned block on one thread therefore lifts the guard for every thread
for its duration. `fp8_autocast`'s function mode and remat's dispatch mode
live on their own stacks and are not touched.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
import traceback
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

#: What a sync under `torch.cuda.set_sync_debug_mode` raises or warns.
_SYNC_RE = re.compile(r"called a synchronizing CUDA operation")
#: `transfer_guard` level -> sync debug mode while armed.
_SYNC_MODES = {"disallow": "error", "log": "warn", "allow": None, None: None}

# The kernel-build listener cannot know which guards are armed, so one
# module-level listener fans out to whatever guards are currently armed.
_ARMED_GUARDS: List["TraceGuard"] = []
_LISTENER_LOCK = threading.Lock()
_LISTENER_INSTALLED = False
# The process-wide sync debug mode's state, under `_SYNC_LOCK`: the guards
# that set a mode (innermost last), the mode found before the first of them
# armed, and how many `allow_sync` blocks are open.
_SYNC_LOCK = threading.Lock()
_SYNC_GUARDS: List["TraceGuard"] = []
_SYNC_STATE = {"base": 0, "allowed": 0}


def _apply_sync_mode():
    """Set the mode from `_SYNC_STATE` and `_SYNC_GUARDS` (caller holds
    `_SYNC_LOCK`)."""
    import torch

    if not _SYNC_GUARDS:
        mode = _SYNC_STATE["base"]
    elif _SYNC_STATE["allowed"]:
        mode = 0
    else:
        mode = _SYNC_MODES[_SYNC_GUARDS[-1].transfer_guard]
    torch.cuda.set_sync_debug_mode(mode)


def _on_build(name: str, seconds: float):
    for guard in list(_ARMED_GUARDS):
        guard.compiles[name] = guard.compiles.get(name, 0) + 1


def _ensure_build_listener():
    global _LISTENER_INSTALLED
    with _LISTENER_LOCK:
        if _LISTENER_INSTALLED:
            return
        from ..ops import _build

        _build.add_build_listener(_on_build)
        _LISTENER_INSTALLED = True


def _torch_dir() -> str:
    import torch

    return os.path.dirname(torch.__file__)


_SKIP_FILES = (os.path.abspath(__file__), os.path.abspath(contextlib.__file__), os.path.abspath(warnings.__file__))


def _user_site(frames) -> str:
    """file:line of the innermost frame that is neither torch's own code nor
    this module's plumbing: the line that asked for the sync. `frames` runs
    outermost first (a `traceback.extract_*` list)."""
    torch_dir = _torch_dir() + os.sep
    for entry in reversed(frames):
        path = os.path.abspath(entry.filename)
        if path in _SKIP_FILES or path.startswith(torch_dir):
            continue
        return f"{entry.filename}:{entry.lineno}"
    return "<unknown>"


@contextlib.contextmanager
def allow_sync():
    """Sanction the host syncs inside the block: the step-boundary pushes and
    drains (JAX's explicit transfers). While any block is open, on any
    thread, an armed guard's mode is lifted; the mode is set again from the
    count when the last one closes. Sets nothing while no guard is armed."""
    with _SYNC_LOCK:
        _SYNC_STATE["allowed"] += 1
        if _SYNC_GUARDS:
            _apply_sync_mode()
    try:
        yield
    finally:
        with _SYNC_LOCK:
            _SYNC_STATE["allowed"] -= 1
            if _SYNC_GUARDS:
                _apply_sync_mode()


class TraceGuardViolation(RuntimeError):
    """A steady-state step built a kernel, or the wrapped step made an
    unsanctioned host sync. Carries the report so CI output names the source
    or the line."""

    def __init__(self, message: str, report: "TraceReport"):
        super().__init__(message)
        self.report = report


@dataclass
class TraceReport:
    """What one armed window observed."""

    compiles: Dict[str, int] = field(default_factory=dict)  # source -> builds
    transfer_violations: List[str] = field(default_factory=list)  # "file:line: message"
    steps: int = 0

    @property
    def backend_compiles(self) -> int:
        """JAX's count of backend compiles; every build has a source name,
        so it is the sum of `compiles`."""
        return sum(self.compiles.values())

    @property
    def total_recompiles(self) -> int:
        return self.backend_compiles

    @property
    def host_transfers(self) -> int:
        return len(self.transfer_violations)

    def summary(self) -> str:
        if not self.compiles and not self.transfer_violations:
            return "clean: 0 recompiles, 0 guarded transfers"
        parts = []
        if self.compiles:
            named = ", ".join(f"{name} x{n}" for name, n in sorted(self.compiles.items()))
            parts.append(f"recompiled: {named}")
        if self.transfer_violations:
            parts.append(f"{len(self.transfer_violations)} guarded transfer(s)")
        return "; ".join(parts)


class TraceGuard:
    """Armed window asserting "this code neither builds a kernel nor makes an
    unsanctioned host sync".

    Parameters (JAX's):
      - ``transfer_guard``: "disallow" (default: a sync raises at its line),
        "log" (a sync warns and is recorded), or None / "allow" (syncs
        unguarded).
      - ``on_violation``: "raise" — exit raises `TraceGuardViolation` when a
        build was observed or a sync error is in flight; "record" — only keep
        the ledger.
      - ``name``: label used in violation messages.
      - ``guard_device_to_device``: taken for JAX's signature and ignored:
        a device-to-device copy never syncs the host in torch.

    The per-window counters (`compiles`, `transfer_violations`, `steps`)
    accumulate across re-entries until `reset()`.
    """

    def __init__(
        self,
        transfer_guard: Optional[str] = "disallow",
        on_violation: str = "raise",
        name: str = "trace-guard",
        guard_device_to_device: bool = False,
    ):
        if on_violation not in ("raise", "record"):
            raise ValueError("on_violation must be 'raise' or 'record'")
        if transfer_guard not in _SYNC_MODES:
            raise ValueError(f"transfer_guard must be one of {sorted(map(str, _SYNC_MODES))}")
        self.transfer_guard = transfer_guard
        self.guard_device_to_device = guard_device_to_device
        self.on_violation = on_violation
        self.name = name
        self.compiles: Dict[str, int] = {}
        self.transfer_violations: List[str] = []
        self.steps = 0
        self._depth = 0
        self._warnings: Optional[warnings.catch_warnings] = None

    # ------------------------------------------------------------------ arming
    def __enter__(self) -> "TraceGuard":
        self._depth += 1
        if self._depth > 1:
            return self
        _ensure_build_listener()
        _ARMED_GUARDS.append(self)
        mode = _SYNC_MODES[self.transfer_guard]
        import torch

        if mode is not None and torch.cuda.is_available():
            if mode == "warn":
                self._capture_sync_warnings()
            with _SYNC_LOCK:
                if not _SYNC_GUARDS:
                    _SYNC_STATE["base"] = torch.cuda.get_sync_debug_mode()
                _SYNC_GUARDS.append(self)
                _apply_sync_mode()
        return self

    def _capture_sync_warnings(self):
        """Route sync warnings into the ledger (each recorded with its user
        frame); every other warning goes on to the handler it would have
        reached."""
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=_SYNC_RE.pattern)
        shown = warnings.showwarning

        def showwarning(message, category, filename, lineno, file=None, line=None):
            if _SYNC_RE.search(str(message)):
                site = _user_site(traceback.extract_stack())
                self.transfer_violations.append(f"{site}: {str(message).splitlines()[0][:160]}")
                return
            shown(message, category, filename, lineno, file, line)

        warnings.showwarning = showwarning

    def _disarm_sync(self):
        with _SYNC_LOCK:
            if self in _SYNC_GUARDS:
                _SYNC_GUARDS.remove(self)
                _apply_sync_mode()
        if self._warnings is not None:
            self._warnings.__exit__(None, None, None)
            self._warnings = None

    def __exit__(self, exc_type, exc, tb):
        self._depth -= 1
        if self._depth > 0:
            return False
        # Disarm from the build fan-out FIRST: builds outside the armed
        # window must not reach this guard's ledger.
        try:
            _ARMED_GUARDS.remove(self)
        except ValueError:
            pass
        self._disarm_sync()
        if exc is not None:
            # An in-flight exception (possibly an unsanctioned sync) wins;
            # record it on the way out. In raise mode a sync error becomes a
            # TraceGuardViolation naming its line.
            if self.observe(exc) and self.on_violation == "raise":
                raise TraceGuardViolation(
                    f"[{self.name}] unsanctioned host sync at {self.transfer_violations[-1]}",
                    self.report(),
                ) from exc
            return False
        if self.on_violation == "raise" and self.report().total_recompiles:
            raise TraceGuardViolation(
                f"[{self.name}] steady-state step recompiled — {self.report().summary()}",
                self.report(),
            )
        return False

    # ------------------------------------------------------------------ ledger
    def reset(self):
        self.compiles = {}
        self.transfer_violations = []
        self.steps = 0

    def report(self) -> TraceReport:
        return TraceReport(
            compiles=dict(self.compiles),
            transfer_violations=list(self.transfer_violations),
            steps=self.steps,
        )

    @property
    def backend_compiles(self) -> int:
        return sum(self.compiles.values())

    @property
    def total_recompiles(self) -> int:
        return self.backend_compiles

    @property
    def host_transfers(self) -> int:
        return len(self.transfer_violations)

    # ----------------------------------------------------------------- helpers
    @staticmethod
    def is_transfer_violation(exc: BaseException) -> bool:
        """Does this exception come from an armed sync guard?"""
        return bool(_SYNC_RE.search(str(exc)))

    def observe(self, exc: BaseException) -> bool:
        """Record `exc` if it is a guarded-sync error, with the user frame
        that made the sync (serving's fault isolation calls this before
        swallowing a step exception, so swallowed violations still reach the
        ledger). An exception already recorded is not counted twice. Returns
        True when `exc` is a guarded-sync error."""
        if not self.is_transfer_violation(exc):
            return False
        if getattr(exc, "_trace_guard_recorded", None) is self:
            return True
        site = _user_site(traceback.extract_tb(exc.__traceback__)) if exc.__traceback__ else "<unknown>"
        self.transfer_violations.append(f"{site}: {str(exc).splitlines()[0][:160]}")
        try:
            exc._trace_guard_recorded = self
        except AttributeError:
            pass
        return True

    def wrap(self, fn: Callable, warmup: int = 1) -> Callable:
        """Per-call arming with a warmup allowance: the first `warmup` calls
        run unguarded (builds are expected), every later call runs inside the
        armed guard — so call N+1 onward raising means a *steady-state*
        build or sync, reported with the source's name or the line."""

        state = {"calls": 0}

        def guarded(*args, **kwargs):
            state["calls"] += 1
            if state["calls"] <= warmup:
                return fn(*args, **kwargs)
            with self:
                # In-flight exceptions (including guarded syncs) are
                # observe()d once by __exit__ on the way out.
                self.steps += 1
                return fn(*args, **kwargs)

        guarded.__wrapped__ = fn  # type: ignore[attr-defined]
        guarded.trace_guard = self  # type: ignore[attr-defined]
        return guarded
