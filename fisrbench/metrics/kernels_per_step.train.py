"""CUDA kernels (copies and sets aside) a training step, from the trace."""

from fisrbench.harness.readers import kernels_per

read = kernels_per("steps")
