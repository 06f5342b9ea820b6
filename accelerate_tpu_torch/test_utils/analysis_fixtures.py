"""Pytest plumbing for the port's trace guard (the port of
`accelerate_tpu/test_utils/analysis_fixtures.py`): import the fixture by name
from a test module (or list this module in ``pytest_plugins``) and any test
can assert "this loop builds exactly N kernels and never syncs":

    from accelerate_tpu_torch.test_utils.analysis_fixtures import assert_compiles, trace_guard

    def test_loop_is_stable(trace_guard):
        guard = trace_guard()           # record-mode TraceGuard
        warmup(step_fn)
        with guard:
            for batch in batches:
                step_fn(batch)
        assert_compiles(guard, exactly=0)
"""

from __future__ import annotations

import pytest

from ..analysis.trace_guard import TraceGuard


@pytest.fixture
def trace_guard():
    """Factory fixture: build record-mode TraceGuards (assertions stay in the
    test, so a failure reports through pytest instead of raising mid-loop).
    Pass on_violation="raise" to get the raising behavior instead."""

    def make(**kwargs) -> TraceGuard:
        kwargs.setdefault("on_violation", "record")
        return TraceGuard(**kwargs)

    return make


def assert_compiles(guard: TraceGuard, exactly: int = None, at_most: int = None):
    """Assert on a guard's build ledger with a readable failure message
    (names every source and its build count), and that it saw no sync."""
    total = guard.total_recompiles
    detail = guard.report().summary()
    if exactly is not None:
        assert total == exactly, (
            f"expected exactly {exactly} compile(s) in the guarded window, saw {total} — {detail}"
        )
    if at_most is not None:
        assert total <= at_most, (
            f"expected at most {at_most} compile(s) in the guarded window, saw {total} — {detail}"
        )
    assert guard.host_transfers == 0, (
        f"guarded window made {guard.host_transfers} host transfer(s): "
        f"{guard.transfer_violations}"
    )
