"""Program span `data.batch` (drawing, cropping, augmenting and stacking a
batch) in ms a batch yielded (`data.batches`), one a step, over the whole
run (in a traced run: the set-up's batches and the traced steps')."""

from fisrbench.harness.program import ms_per

read = ms_per(("data.batch",), "data.batches")
