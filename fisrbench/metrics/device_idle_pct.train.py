"""Share of the traced steps with nothing running on the device."""

from fisrbench.harness.readers import device_idle_pct

read = device_idle_pct
