"""Twins of the JAX package's `examples/by_feature/` scripts, runnable as
``python -m accelerate_tpu_torch.examples.by_feature.<name>``."""
