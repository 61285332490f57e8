#!/usr/bin/env python3
"""Wall time of fisr_tpu_torch's fused run_video_pipeline on one CUDA card.

    python3 scripts/time_torch_pipeline.py [--root DIR] [--frames 6] [--calls 3]

Writes `--frames` synthetic 1024x1920 YUV PNGs, then runs the fused bf16
pipeline (full-width deterministic weights, flow_upscale=2) `--calls` times
and prints each call's wall seconds (the first pays the conv library's
set-up) with the card's name and power limit. `--root` names the tree whose
fisr_tpu_torch is imported: this script's repository (the default) or a copy
of another commit unpacked inside it (e.g. `git archive` into `build/`), so
two trees can be timed in turns on one card; a directory outside the
repository is refused. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def synthetic_frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy = rng.uniform(0.01, 0.03, 2)
    phase = rng.uniform(0, 6.28, 3)
    return np.stack([np.stack([127.5 + 100 * np.sin(fx * (xx - 3 * t) + fy * (yy - 2 * t) + phase[c])
                               for c in range(3)], -1) for t in range(n)]).astype(np.uint8)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    repo = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
    ap.add_argument("--root", default=repo)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--calls", type=int, default=3)
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
    walls = []
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "frames")
        os.makedirs(folder)
        for i, fr in enumerate(synthetic_frames(args.frames, 1024, 1920)):
            write_png(fr, os.path.join(folder, f"frame_{i:03d}.png"))
        for _ in range(args.calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                outs = run_video_pipeline(fisr, pwc, folder, out_folder=os.path.join(tmp, "out"),
                                          policy=BF16, fused=True, flow_upscale=2, device="cuda",
                                          verbose=False)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{smi}; {os.path.abspath(args.root)}: {args.frames} frames -> {len(outs)} outputs, "
          f"wall s per call {[round(t, 3) for t in walls]}")
    print(json.dumps({"card": smi, "root": os.path.abspath(args.root), "frames": args.frames,
                      "outputs": len(outs), "wall_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
