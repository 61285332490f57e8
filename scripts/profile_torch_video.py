#!/usr/bin/env python3
"""Where the time of fisr_tpu_torch's fused video path goes on one CUDA card.

    python3 scripts/profile_torch_video.py [--height 1024 --width 1920] [--reps 5]
                                           [--fisr_grid full|auto|GH,GW]

Full-width deterministic weights (FISRnet ch=64, PWC-Net lg-6-2), bf16,
flow_upscale=2, one window's steady state = one frame pair + one window.
`--fisr_grid` picks the window stage's FISRnet tiling plan as the CLI's flag
does (default: full frame).
Prints, from CUDA events: flow, middle-frame warp and FISRnet-window times;
from torch.profiler over `reps` steady windows: device time by kernel family,
the top kernels, and the device's busy share of the profiled wall time. The
last line is one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("cost_volume", ("cost_volume_kernel",)),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "gemm", "winograd", "fft", "sm90", "dgrad",
              "wgrad", "nhwc", "cutlass")),
    ("gather_index", ("index", "gather", "scatter")),
    ("copy_cat_pad", ("cat", "copy", "pad", "transpose", "permute", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "clamp", "leaky", "relu", "max_pool")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def time_ms(fn, reps):
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--fisr_grid", type=str, default="full")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_video: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from fisr_tpu_torch.cli._common import parse_grid
    from fisr_tpu_torch.convert import params
    from fisr_tpu_torch.infer.video import (make_fisr_window_fn, make_flow_fn, make_pair_fn,
                                            make_warp_fn, resolve_fisr_plan)
    from fisr_tpu_torch.ops.conv import BF16

    dev = torch.device("cuda")
    fisr = params.deterministic_fisrnet(device=dev)
    pwc = params.deterministic_pwcnet(device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    d = [torch.rand((1, args.height, args.width, 3), device=dev, generator=g) * 255
         for _ in range(3)]
    flow_fn, warp_fn = make_flow_fn(pwc.cfg, BF16, 2), make_warp_fn()
    fisr_grid = parse_grid(args.fisr_grid)
    plan = None if fisr_grid is None else resolve_fisr_plan(fisr_grid, args.height, args.width, BF16)
    pair_fn = make_pair_fn(pwc.cfg, BF16, 2)
    window_fn = make_fisr_window_fn(BF16, fisr_grid=fisr_grid)
    with torch.inference_mode():
        p01, p12 = pair_fn(pwc, d[0], d[1]), pair_fn(pwc, d[1], d[2])
        win = torch.stack(d, dim=1)
        stages = {
            "flow_ms": time_ms(lambda: flow_fn(pwc, d[0], d[1]), args.reps),
            "warp_ms": time_ms(lambda: warp_fn(d[0], d[1], p01[0]), args.reps),
            "window_ms": time_ms(lambda: window_fn(fisr, win, p01, p12), args.reps),
        }

        def steady():
            pair_fn(pwc, d[1], d[2])
            window_fn(fisr, win, p01, p12)

        steady()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                steady()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / args.reps

    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time / 1e3 / args.reps
    by_family = {}
    for name, ms in kernels.items():
        by_family[family(name)] = by_family.get(family(name), 0.0) + ms
    busy = sum(kernels.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{smi}; {args.height}x{args.width} bf16, flow_upscale 2, fisr_grid {args.fisr_grid} "
          f"(plan {plan})")
    print(f"stages (CUDA events, ms): {stages}")
    print(f"steady window (1 pair + 1 window): wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f} %)")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:14s} {ms:9.3f} ms  {100 * ms / busy:5.1f} %")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    for name, ms in top:
        print(f"  {ms:9.3f} ms  {name[:110]}")
    print(json.dumps({"card": smi, "shape": [args.height, args.width],
                      "fisr_grid": args.fisr_grid, "plan": plan, **stages,
                      "steady_wall_ms": wall_ms, "device_busy_ms": busy,
                      "by_family_ms": by_family,
                      "top_kernels_ms": {n[:110]: ms for n, ms in top}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
