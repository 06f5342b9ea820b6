"""Ops of the port (attention, fp8 products, activation checkpointing,
quantization) and the kernels under them. Importing this package builds
nothing: a kernel is compiled at the first call that hands it a CUDA tensor
(`ops/_build.py`)."""
