"""Launched correctness scripts (the port of `accelerate_tpu/test_utils/scripts/`:
`test_script.py`, `test_sync.py`, `test_ops.py`). Each has a `main()`, so it
runs as ``python <script>`` at one process, on the card or under
``ACCELERATE_TPU_USE_CPU=1``, or is handed to `debug_launcher` across
processes."""
