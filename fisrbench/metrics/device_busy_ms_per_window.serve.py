"""Device busy ms a window of the service's window path, traced after the window."""

from fisrbench.harness.readers import device_busy_ms_per

read = device_busy_ms_per("windows")
