"""The cost-volume backward's least time over its device time, traced steps."""

from fisrbench.harness.readers import roofline_pct

read = roofline_pct("cv_bwd")
