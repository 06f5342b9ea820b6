"""Test utilities shipped with the port (`analysis_fixtures`: the
`trace_guard` fixture and `assert_compiles`). Nothing is imported here:
`analysis_fixtures` imports pytest, which a training script need not have."""
