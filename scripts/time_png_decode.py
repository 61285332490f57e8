#!/usr/bin/env python3
"""Host time of fisr_tpu_torch's PNG decoders by row filter type.

    python3 scripts/time_png_decode.py [--root DIR] [--height 1024] [--width 1920] [--reps 1]

Builds one random 8-bit RGB frame and four PNGs of it whose rows are all
Paeth-, all Average-, all None-filtered, or cycle through the five filter
types (the filtering is done here in numpy; zlib level 1), reads each with
the plain decoder `fisr_tpu_torch.data.png_io.read_png` and, where the tree
has it, the host runtime's `fisr_tpu_torch.native.decode_png` (C++, built
with g++ at first use), from `--root` (this repository by default, or
another commit's tree unpacked inside it, e.g. `git archive` into `build/`),
checks the pixels byte for byte and prints the seconds of each read with the
CPU's name and cores. The last line is one JSON object. CPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

KINDS = {"paeth": 4, "average": 3, "mixed": None, "none": 0}


def filtered_png(img: np.ndarray, ftypes) -> bytes:
    """8-bit RGB PNG of `img` whose row y is filtered with ftypes[y]."""
    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int64)
    up = np.vstack([np.zeros((1, w * c), np.int64), cur[:-1]])
    left = np.hstack([np.zeros((h, c), np.int64), cur[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int64), up[:, :-c]])
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(cur), left, up, (left + up) // 2, paeth])
    ft = np.asarray(ftypes, np.uint8)
    pred = np.take_along_axis(preds, ft[None, :, None].astype(np.int64), 0)[0]
    raw = np.hstack([ft[:, None], ((cur - pred) % 256).astype(np.uint8)])

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    repo = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
    ap.add_argument("--root", default=repo)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    if os.path.commonpath([repo, os.path.realpath(args.root)]) != repo:
        ap.error(f"--root must lie inside {repo}")
    sys.path.insert(0, os.path.abspath(args.root))
    from fisr_tpu_torch.data.png_io import read_png

    decoders = {"plain": read_png}
    try:
        from fisr_tpu_torch import native
    except ImportError:  # a tree before the host runtime
        native = None
    if native is not None:
        native.available()  # build before the first timed read
        decoders["native"] = native.decode_png
    img = np.random.default_rng(0).integers(0, 256, (args.height, args.width, 3), np.uint8)
    sec = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, ftype in KINDS.items():
            rows = [y % 5 if ftype is None else ftype for y in range(args.height)]
            path = os.path.join(tmp, f"{kind}.png")
            with open(path, "wb") as f:
                f.write(filtered_png(img, rows))
            for name, decode in decoders.items():
                key = kind if name == "plain" else f"{kind}_{name}"
                sec[key] = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    got = decode(path)
                    sec[key].append(time.perf_counter() - t0)
                    if not np.array_equal(got, img):
                        raise AssertionError(f"{key}: decoded pixels differ")
                print(f"{key}: " + ", ".join(f"{s:.4f}" for s in sec[key]) + " s", flush=True)
    print(json.dumps({"cpu": cpu_name(), "cores": os.cpu_count(), "root": args.root,
                      "frame": [args.height, args.width], "sec": sec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
