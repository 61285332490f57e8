"""3 x forward FLOPs of the traced steps over their length at the dtype's peak."""

from fisrbench.harness.readers import mfu_pct

read = mfu_pct
