"""Twins of the JAX package's `examples/inference/` scripts, runnable as
``python -m accelerate_tpu_torch.examples.inference.<name>``."""
