#!/usr/bin/env python3
"""Card time of the f32 cost-volume kernel, against other builds of it, on one CUDA card.

    python3 scripts/time_cost_volume_variants.py [--parent DIR] [--tile ROWSxPIXELS ...]

Builds `fisr_tpu_torch/csrc/cost_volume.cu` as it is, and beside it: with
`--parent`, the same file of another tree unpacked inside the repository
(e.g. `git archive` of the parent commit into `build/`); with each `--tile`,
a copy whose f32 tile (FR output rows x FTX pixels a block) is swapped.
Each build goes to `build/variants/` through `nvcc` with the port's flags.
Every build is held against the plain version (atol = rtol = 1e-5), then
timed in turns (this tree, the others, twice over) at the five PWC-Net
level shapes of a 1024x1920 window after the x2 upscale (B=2, d=4): card
time of one call from a CUDA-graph replay (chip_smoke.graph_time_ms). Prints
the card's name and power limit, and as its last line one JSON object:
{build: {level: ms}} with the pair's sum under "pair".
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from fisr_tpu_torch.kernels import build  # noqa: E402
from fisr_tpu_torch.ops.cost_volume import cost_volume as plain  # noqa: E402

SOURCE = os.path.join(ROOT, "fisr_tpu_torch", "csrc", "cost_volume.cu")


def sources(args):
    """{name: source text} of every build to time."""
    with open(SOURCE) as f:
        here = f.read()
    out = {"this": here}
    if args.parent:
        parent = os.path.realpath(args.parent)
        if not parent.startswith(ROOT + os.sep):
            raise SystemExit(f"--parent {args.parent}: not inside the repository")
        with open(os.path.join(parent, "fisr_tpu_torch", "csrc", "cost_volume.cu")) as f:
            out["parent"] = f.read()
    for tile in args.tile:
        rows, pixels = (int(v) for v in tile.split("x"))
        text = here.replace("constexpr int FR = 8;", f"constexpr int FR = {rows};")
        text = text.replace("constexpr int FTX = 16;", f"constexpr int FTX = {pixels};")
        if text == here and tile != "8x16":
            raise SystemExit("the f32 tile constants were not found in the source")
        out[f"tile_{tile}"] = text
    return out


def build_all(srcs):
    """Build every source at once; {name: its fisr_cost_volume}."""
    target = os.path.join(ROOT, "build", "variants")
    os.makedirs(target, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(target, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(target, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(so).fisr_cost_volume
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="another tree, inside the repository")
    ap.add_argument("--tile", action="append", default=[], help="an f32 tile, e.g. 4x32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    fns = build_all(sources(args))

    def call(fn, a, b, out):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), *a.shape, chip_smoke.D, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")

    g = torch.Generator(device="cuda").manual_seed(0)
    times = {name: {} for name in fns}
    hh, ww = (s * chip_smoke.FLOW_UPSCALE for s in chip_smoke.WINDOW)
    for lvl, c in chip_smoke.LEVEL_CHANNELS.items():
        shape = (2, hh >> lvl, ww >> lvl, c)
        a, b = (torch.randn(shape, device="cuda", generator=g) for _ in range(2))
        want = plain(a, b, chip_smoke.D)
        out = torch.empty_like(want)
        for name, fn in fns.items():
            call(fn, a, b, out)
            torch.cuda.synchronize()
            if not torch.allclose(out, want, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{name} at {shape}: max |diff| {(out - want).abs().max()}")
        for _ in range(2):  # in turns, twice over: the second round is kept
            for name, fn in fns.items():
                times[name][lvl] = chip_smoke.graph_time_ms(lambda: call(fn, a, b, out))
        print(f"level {lvl} {list(shape)}: "
              + ", ".join(f"{n} {t[lvl]:.4f} ms" for n, t in times.items()), flush=True)
    for t in times.values():
        t["pair"] = sum(t.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
