"""Program counter `png.bytes` (the bytes of every PNG the host runtime
encoded: the RGB and YUV files of the writer threads) in MB (10^6 bytes) an
output frame (`video.frames`), over every clip of the run. None where the
program does not count the bytes (as before the encoder counted them) or no
frame was written."""

from fisrbench.harness.program import totals


def read(_reading):
    t = totals()
    if t is None:
        return None
    c = t["counters"]
    if "png.bytes" not in c or not c.get("video.frames"):
        return None
    return c["png.bytes"] / 1e6 / c["video.frames"]
