"""Share of the traced time with nothing running on the device, over the
service's window path called back to back after the window (no HTTP, no
lock contention): the path's own host work between kernels."""

from fisrbench.harness.readers import device_idle_pct

read = device_idle_pct
