"""Device busy ms (union of device intervals) an output frame, traced clip."""

from fisrbench.harness.readers import device_busy_ms_per

read = device_busy_ms_per("frames")
