#!/usr/bin/env python3
"""Time the cost volume's backward kernels of this tree against another tree's, on one CUDA card.

    python3 scripts/time_cost_volume_backward.py --root DIR [--rounds 2]

Builds fisr_tpu_torch/csrc/cost_volume.cu of this repository and of `--root`
(a copy of another commit unpacked inside the repository, e.g. `git archive`
of the parent into `build/`; a directory outside it is refused) with this
tree's nvcc flags, one nvcc each, both started together, into
build/time_cost_volume_backward/. Loads both libraries in one process, holds
each against the plain backward (fisr_tpu_torch/ops/cost_volume.py: f32
within 1e-5, bf16 within one bf16 ulp), and times one backward (both
gradients) at the five level shapes of a pwc_train step ([8, 256>>l, 448>>l,
C]) and of a joint step ([4, 192>>l, 192>>l, C]), f32 and bf16: the card's
time from a CUDA-graph replay of 20 launches, the two trees in turns,
`--rounds` times, beside each shape's byte bound (g, c1, c2 read once, dc1,
dc2 written once at 3.35 TB/s). This tree's source is also built once for
each of the bf16 kernel's tiles with the choice forced (`this_t0`,
`this_t1`, ...: bwd_bf16_tile_choice's switch replaced by the tile's index)
and timed beside the others in bf16. Prints the card's name and power limit;
the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
LEVEL_CHANNELS = {2: 32, 3: 64, 4: 96, 5: 128, 6: 196}
SHAPES = {"pwc_train": [(8, 256 >> lvl, 448 >> lvl, c) for lvl, c in LEVEL_CHANNELS.items()],
          "joint": [(4, 192 >> lvl, 192 >> lvl, c) for lvl, c in LEVEL_CHANNELS.items()]}
D = 4


def bound_ms(shape, dtype):
    b, h, w, c = shape
    item = torch.tensor([], dtype=dtype).element_size()
    return 1e3 * b * h * w * ((2 * D + 1) ** 2 + 4 * c) * item / HBM_BYTES_PER_S


def graph_ms(fn, reps=20, replays=5):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / replays / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    repo = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
    ap.add_argument("--root", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    root = os.path.realpath(args.root)
    if os.path.commonpath([repo, root]) != repo:
        ap.error(f"--root must lie inside {repo}")
    if not torch.cuda.is_available():
        print("time_cost_volume_backward: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, repo)
    from fisr_tpu_torch.kernels import build
    from fisr_tpu_torch.ops.cost_volume import cost_volume_backward

    out_dir = os.path.join(repo, "build", "time_cost_volume_backward")
    os.makedirs(out_dir, exist_ok=True)
    sources = {name: os.path.join(tree, "fisr_tpu_torch", "csrc", "cost_volume.cu")
               for name, tree in (("this", repo), ("root", root))}
    with open(sources["this"]) as f:
        text = f.read()
    tiles = re.search(r"BF16_TILES\[(\d+)\]", text)
    choice = re.search(r"switch \(bwd_bf16_tile_choice\([^;]*\)\) \{", text)
    if not (tiles and choice):
        raise RuntimeError("this tree's source has no bf16 tile choice to force")
    forced = []  # timed in bf16 only
    for k in range(int(tiles.group(1))):
        forced.append(f"this_t{k}")
        sources[forced[-1]] = os.path.join(out_dir, f"{forced[-1]}.cu")
        with open(sources[forced[-1]], "w") as f:
            f.write(text.replace(choice.group(0), f"switch ({k}) {{"))
    procs = {}
    for name, src in sources.items():
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(out_dir, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} tree:\n{err}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.fisr_cost_volume_backward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                                  + [ctypes.c_void_p])
        libs[name] = lib

    def backward(lib, a, b, g):
        dc1, dc2 = torch.empty_like(a), torch.empty_like(b)
        err = lib.fisr_cost_volume_backward(
            a.data_ptr(), b.data_ptr(), g.data_ptr(), dc1.data_ptr(), dc2.data_ptr(), *a.shape,
            D, 0 if a.dtype == torch.float32 else 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"backward launch failed ({err})")
        return dc1, dc2

    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    rows = []
    for step, shapes in SHAPES.items():
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                a, b = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in "ab")
                g = torch.randn(tuple(shape[:3]) + ((2 * D + 1) ** 2,), device="cuda",
                                generator=gen).to(dtype)
                want = [w.float() for w in cost_volume_backward(a, b, g, D)]
                names = [n for n in libs if dtype == torch.bfloat16 or n not in forced]
                for name in names:
                    lib = libs[name]
                    for x, y in zip(backward(lib, a, b, g), want):
                        x = x.float()
                        ok = (torch.allclose(x, y, rtol=1e-5, atol=1e-5) if dtype == torch.float32
                              else bool(((x - y).abs() <= 1e-5 + 2.0**-7 * y.abs()).all()))
                        if not ok:
                            raise AssertionError(f"{name} tree's backward {shape} {dtype}: max "
                                                 f"|diff| {(x - y).abs().max().item()}")
                times = {name: [] for name in names}
                for rnd in range(args.rounds):
                    order = names if rnd % 2 == 0 else names[::-1]
                    for name in order:
                        times[name].append(graph_ms(lambda: backward(libs[name], a, b, g)))
                row = {"step": step, "shape": list(shape), "dtype": str(dtype).split(".")[1],
                       "bound_ms": bound_ms(shape, dtype),
                       **{f"{name}_ms": min(t) for name, t in times.items()},
                       **{f"{name}_runs_ms": t for name, t in times.items()}}
                rows.append(row)
                print(f"{step} {tuple(shape)} {row['dtype']}: "
                      + ", ".join(f"{n} {row[n + '_ms']:.4f} ms" for n in names)
                      + f", bound {row['bound_ms']:.4f} ms", flush=True)
    totals = {f"{step}_{dt}_{name}_ms": sum(r[f"{name}_ms"] for r in rows
                                           if r["step"] == step and r["dtype"] == dt)
              for step in SHAPES for dt in ("float32", "bfloat16") for name in libs
              if dt == "bfloat16" or name not in forced}
    print(json.dumps({"totals": totals, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
