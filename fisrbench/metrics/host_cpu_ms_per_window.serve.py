"""Server process CPU ms (all threads) over the window a served window."""

from fisrbench.harness.readers import host_cpu_ms_per

read = host_cpu_ms_per("windows")
