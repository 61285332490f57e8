"""Device busy ms a training step, traced steps."""

from fisrbench.harness.readers import device_busy_ms_per

read = device_busy_ms_per("steps")
