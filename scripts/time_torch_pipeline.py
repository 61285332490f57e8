#!/usr/bin/env python3
"""Wall time of fisr_tpu_torch's fused run_video_pipeline on one CUDA card,
and where the host spends it.

    python3 scripts/time_torch_pipeline.py [--root DIR] [--frames 6] [--calls 3] [--filtered]
                                           [--keep DIR]

Writes `--frames` synthetic 1024x1920 YUV PNGs (filter 0 rows; with
`--filtered`, Paeth rows, as users' PNG encoders write them), then runs the
fused bf16 pipeline (full-width deterministic weights, flow_upscale=2)
`--calls` times and prints each call's wall seconds (the first pays the conv
library's set-up) with the card's name and power limit and the host's cores.
For each call it also prints the host stages, a window (seconds summed over
the threads that ran them, divided by the windows; host clock): decode,
upload, card wait, colour, encode and file write. They are read by wrapping
the functions the pipeline calls for each (`instrumented`): the host runtime's
in this tree, the plain versions in a tree before it (read_png,
yuv2rgb_matlab_u8, write_png = encode_png + the file).

`--root` names the tree whose fisr_tpu_torch is imported: this script's
repository (the default) or a copy of another commit unpacked inside it (e.g.
`git archive` into `build/`), so two trees can be timed in turns on one card;
a directory outside the repository is refused. The last line is one JSON
object. `--keep DIR` copies the last call's output PNGs there, to compare
two trees' frames.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

STAGES = ("decode", "upload", "card_wait", "colour", "encode", "write")


def synthetic_frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy = rng.uniform(0.01, 0.03, 2)
    phase = rng.uniform(0, 6.28, 3)
    return np.stack([np.stack([127.5 + 100 * np.sin(fx * (xx - 3 * t) + fy * (yy - 2 * t) + phase[c])
                               for c in range(3)], -1) for t in range(n)]).astype(np.uint8)


@contextlib.contextmanager
def instrumented(stages: dict):
    """Within the block, each call the fused pipeline of the imported
    fisr_tpu_torch makes for a host stage adds its seconds to stages[name]
    (summed over threads). Restores the functions on exit."""
    import fisr_tpu_torch.data.png_io as png_io
    import fisr_tpu_torch.infer.video as video

    lock = threading.Lock()

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        return run

    hooks = [  # (owner, attribute, stage); the names either tree has
        (video, "decode_png_batch", "decode"), (video, "read_png", "decode"),
        (video, "_upload", "upload"), (torch.cuda.Event, "synchronize", "card_wait"),
        (video, "yuv2rgb_ops_u8", "colour"), (video, "yuv2rgb_matlab_u8", "colour"),
        (video, "encode_png_bytes", "encode"), (video, "_write_file", "write"),
        (png_io, "encode_png", "encode"), (video, "write_png", "encode+write"),
    ]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in hooks
             if hasattr(owner, attr)]
    try:
        for owner, attr, name in hooks:
            if hasattr(owner, attr):
                setattr(owner, attr, timed(name, getattr(owner, attr)))
        yield stages
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
        if "encode+write" in stages:  # write_png = encode_png + the file
            stages["write"] = stages.pop("encode+write") - stages.get("encode", 0.0)


def per_window(stages: dict, windows: int) -> dict:
    return {k: stages.get(k, 0.0) / windows for k in STAGES}


def host_cores() -> int:
    return len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    repo = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
    ap.add_argument("--root", default=repo)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--filtered", action="store_true",
                    help="write the input PNGs with Paeth rows (default: filter 0)")
    ap.add_argument("--keep", help="copy the last call's output PNGs into this directory")
    args = ap.parse_args()
    if os.path.commonpath([repo, os.path.realpath(args.root)]) != repo:
        ap.error(f"--root must lie inside {repo}")
    if not torch.cuda.is_available():
        print("time_torch_pipeline: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from fisr_tpu_torch.convert import params
    from fisr_tpu_torch.data.png_io import write_png
    from fisr_tpu_torch.infer.video import run_video_pipeline
    from fisr_tpu_torch.ops.conv import BF16

    fisr = params.deterministic_fisrnet(device="cuda")
    pwc = params.deterministic_pwcnet(device="cuda")
    walls, stages = [], []
    windows = args.frames - 2
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "frames")
        os.makedirs(folder)
        for i, fr in enumerate(synthetic_frames(args.frames, 1024, 1920)):
            path = os.path.join(folder, f"frame_{i:03d}.png")
            if args.filtered:  # every row Paeth (this directory's numpy filterer)
                from time_png_decode import filtered_png

                with open(path, "wb") as f:
                    f.write(filtered_png(fr, [4] * fr.shape[0]))
            else:
                write_png(fr, path)
        for _ in range(args.calls):
            torch.cuda.synchronize()
            with instrumented({}) as st:
                t0 = time.perf_counter()
                with torch.inference_mode():
                    outs = run_video_pipeline(fisr, pwc, folder,
                                              out_folder=os.path.join(tmp, "out"), policy=BF16,
                                              fused=True, flow_upscale=2, device="cuda",
                                              verbose=False)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            stages.append(per_window(st, windows))
        if args.keep:
            shutil.copytree(os.path.join(tmp, "out"), args.keep, dirs_exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    inputs = "Paeth-filtered" if args.filtered else "filter-0"
    print(f"{smi}; {host_cores()} host cores; {os.path.abspath(args.root)}: {args.frames} "
          f"{inputs} frames -> {len(outs)} outputs, wall s per call "
          f"{[round(t, 3) for t in walls]}")
    for i, st in enumerate(stages):
        print(f"  call {i}: s a window " + ", ".join(f"{k} {v:.4f}" for k, v in st.items()))
    print(json.dumps({"card": smi, "host_cores": host_cores(), "root": os.path.abspath(args.root),
                      "frames": args.frames, "filtered": args.filtered, "outputs": len(outs),
                      "wall_s": walls, "stages_s_per_window": stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
