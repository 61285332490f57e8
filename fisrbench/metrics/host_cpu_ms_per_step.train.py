"""Process CPU ms (all threads) a training step, untraced part of the window."""

from fisrbench.harness.readers import host_cpu_ms_per

read = host_cpu_ms_per("steps")
