"""Runtime analysis of the port (the runtime half of
`accelerate_tpu/analysis/`): `TraceGuard`, which proves that a steady-state
engine step or fused train step builds no kernel and makes no unsanctioned
host sync. JAX's static linter is not ported.

The names load lazily (module ``__getattr__``), as JAX's do.
"""

_LAZY_RUNTIME = ("TraceGuard", "TraceGuardViolation", "TraceReport", "allow_sync")


def __getattr__(name):
    if name in _LAZY_RUNTIME:
        from . import trace_guard

        return getattr(trace_guard, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_LAZY_RUNTIME)
