"""Program span `data.augment` as a share of `data.batch`: the part of batch
assembly spent in augmentation, over the whole run."""

from fisrbench.harness.program import pct_of

read = pct_of("data.augment", "data.batch")
