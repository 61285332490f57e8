"""The bf16 cost volume's least time over its device time, traced clip."""

from fisrbench.harness.readers import roofline_pct

read = roofline_pct("cv_fwd")
