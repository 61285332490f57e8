"""Useful FLOPs of the windows the clients completed in the window over its
length, at the configuration's peak."""

from fisrbench.harness.readers import mfu_under_load_pct

read = mfu_under_load_pct
