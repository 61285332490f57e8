"""Program span `video.flush` (the wait on the writer threads after a clip's
last window) in ms an output frame (`video.frames`), over every clip of the
run."""

from fisrbench.harness.program import ms_per

read = ms_per(("video.flush",), "video.frames")
