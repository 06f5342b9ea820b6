"""Attention ops of the port and the kernels under them. Importing this
package builds nothing: a kernel is compiled at the first call that hands it
a CUDA tensor (`ops/_build.py`)."""
