"""Process CPU ms (all threads) a FISRnet training step, untraced part of the
window: dispatch of the eager step, the batch's gather and pin, the loop."""

from fisrbench.harness.readers import host_cpu_ms_per

read = host_cpu_ms_per("steps")
