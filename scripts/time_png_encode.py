#!/usr/bin/env python3
"""Host time and bytes of fisr_tpu_torch's PNG encoder against its plain one.

    python3 scripts/time_png_encode.py [--root DIR] [--frames 2] [--reps 3] [--callers 4]
                                       [--pngs FILE ...]

Makes `--frames` frames of the benchmark's video scene
(`fisrbench/harness/scene.clip`, 1056x1920 YUV, on the card when there is
one) upscaled 2x (bicubic) to the video cell's output size, 2112x3840, and
encodes each as the video writers do: as YUV and as RGB
(`native.yuv2rgb_ops_u8`). It prints, for each file kind:

* `plain`: `data/png_io.encode_png` (filter 0, zlib level 1, one thread);
* `native_t1`: the host runtime's `encode_png_bytes(threads=1)`;

MB/s of rows in (h * (1 + 3 w) bytes) and the bytes out, best of `--reps`;
then `concurrent`: `--callers` threads at once, each encoding every file
with the default threads (the host's cores), as the writer threads call it:
the wall ms a file, the ms of one call and the CPU ms a file (os.times of
the process). Every file is decoded by `png_io.decode_png` and compared
pixel for pixel. `--pngs` times the frames of PNG files instead, each its
own kind (e.g. the video cell's outputs). `--root` times another tree (a
commit unpacked inside this repository with `git archive`, e.g. into
`build/`). The last line is one JSON object. CPU only, but it names the
card's host when run there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np


def scene_frames(n: int, seed: int = 3240000023):
    """n YUV frames [2112, 3840, 3] u8: the video cell's scene at its window
    size, upscaled 2x."""
    import torch
    import torch.nn.functional as F

    from fisrbench.harness import scene

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    g = torch.Generator(device=dev).manual_seed(seed)
    yuv = scene.clip(g, n, 1056, 1920, 6.0, 8, (60, 200), (4.0, 16.0), dev)
    up = F.interpolate(yuv.permute(0, 3, 1, 2).float(), scale_factor=2, mode="bicubic",
                       align_corners=False)
    return list(up.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    repo = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
    ap.add_argument("--root", default=repo)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--callers", type=int, default=4)
    ap.add_argument("--pngs", nargs="*", default=[], help="frames to time instead of the scene")
    args = ap.parse_args()
    if os.path.commonpath([repo, os.path.realpath(args.root)]) != repo:
        ap.error(f"--root must lie inside {repo}")
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, repo)  # the benchmark's scene, whatever the tree
    from fisr_tpu_torch import native
    from fisr_tpu_torch.data import png_io
    from scripts.time_png_decode import cpu_name

    native.available()  # build before the first timed call
    files = [(os.path.basename(p), png_io.read_png(p)) for p in args.pngs]
    if not files:
        for yuv in scene_frames(args.frames):
            files += [("yuv", np.ascontiguousarray(yuv)), ("rgb", native.yuv2rgb_ops_u8(yuv))]
    raw = files[0][1].shape[0] * (1 + 3 * files[0][1].shape[1])
    coders = {"plain": png_io.encode_png,
              "native_t1": lambda img: native.encode_png_bytes(img, threads=1)}
    out = {}
    for name, encode in coders.items():
        for kind in dict.fromkeys(k for k, _ in files):
            secs, sizes = [], []
            for _, img in (f for f in files if f[0] == kind):
                best = None
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    data = encode(img)
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
                if not np.array_equal(png_io.decode_png(data), img):
                    raise AssertionError(f"{name} {kind}: decoded pixels differ")
                secs.append(best)
                sizes.append(len(data))
            key = f"{name}_{kind}"
            out[key] = {"mb_s": [raw / s / 1e6 for s in secs], "bytes": sizes}
            print(f"{key}: " + ", ".join(f"{raw / s / 1e6:.1f} MB/s" for s in secs)
                  + f"; bytes {sizes} (ratio {raw * len(sizes) / sum(sizes):.2f})", flush=True)

    calls, lock = [], threading.Lock()

    def caller():
        for _, img in files:
            t0 = time.perf_counter()
            native.encode_png_bytes(img)
            dt = time.perf_counter() - t0
            with lock:
                calls.append(dt)

    for rep in range(args.reps):
        calls.clear()
        threads = [threading.Thread(target=caller) for _ in range(args.callers)]
        cpu0, t0 = os.times(), time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall, cpu1 = time.perf_counter() - t0, os.times()
        n = len(calls)
        cpu = (cpu1.user - cpu0.user) + (cpu1.system - cpu0.system)
        rec = {"wall_ms_per_file": 1e3 * wall / n, "call_ms": 1e3 * float(np.mean(calls)),
               "cpu_ms_per_file": 1e3 * cpu / n}
        out.setdefault("concurrent", []).append(rec)
        print(f"concurrent ({args.callers} callers, {n} files): "
              + ", ".join(f"{k} {v:.1f}" for k, v in rec.items()), flush=True)
    print(json.dumps({"cpu": cpu_name(), "cores": os.cpu_count(), "root": args.root,
                      "frame": list(files[0][1].shape), "callers": args.callers, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
