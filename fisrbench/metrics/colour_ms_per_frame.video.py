"""Program span `video.colour` (YUV to RGB on the writer threads) in ms an
output frame (`video.frames`), over every clip of the run."""

from fisrbench.harness.program import ms_per

read = ms_per(("video.colour",), "video.frames")
