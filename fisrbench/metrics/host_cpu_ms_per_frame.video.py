"""Process CPU ms (all threads) an output frame, untraced part of the window."""

from fisrbench.harness.readers import host_cpu_ms_per

read = host_cpu_ms_per("frames")
