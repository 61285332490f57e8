"""Useful FLOPs of the traced clip over its length at the bf16 peak."""

from fisrbench.harness.readers import mfu_pct

read = mfu_pct
