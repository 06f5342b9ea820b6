"""Test utilities shipped with the port (the port of `accelerate_tpu/test_utils/`):
`testing` (singleton resets, capability skips, child environments),
`training` (the regression fixtures), `scripts/` (the launched correctness
scripts behind ``accelerate-tpu-torch test``) and `analysis_fixtures` (the
`trace_guard` fixture and `assert_compiles`). Nothing is imported here:
`analysis_fixtures` imports pytest, which a training script need not have."""
