"""Examples of the port, runnable as ``python -m accelerate_tpu_torch.examples.<name>``."""
