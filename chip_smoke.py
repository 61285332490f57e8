#!/usr/bin/env python3
"""Drive the fisr_tpu_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. build  - nvcc builds every kernel of the fused video path from
   fisr_tpu_torch/csrc/ (one nvcc per source, all started together); ptxas
   must report no spills for the bf16 tensor-core kernel.
2. kernel - the cost-volume kernels (bf16: mma.sync, f32: FMA) against the
   plain PyTorch version on the card at the five PWC-Net level shapes of a
   1024x1920 window (B=2, d=4), at ragged shapes (d=2 and 4, odd W and H,
   C=3, 20, 196), and the gradient. At the level shapes the kernel is timed
   with CUDA events twice: call by call through the wrapper (`ms`, which at
   the small levels is the host's time to launch) and replaying a CUDA graph
   of launches (`graph_ms`, the card's time alone); the plain version call by
   call.
3. small  - make_fused_video_step at 64x64 with full-width weights in f32,
   kernel against plain version (TF32 off), and the port's PWC-Net and
   FISRnet on the card against the TF-oracle fixtures of tests/fixtures/.
4. full   - run_video_pipeline(fused=True) on 4 synthetic 1024x1920 YUV
   PNG frames, full-width FISRnet (ch=64) and PWC-Net lg-6-2, bf16,
   flow_upscale=2: 6 outputs of 2048x3840, 15 cost-volume launches
   (3 pairs x 5 levels, all of the bf16 variant); then per-pair and per-window
   times and peak memory.

Prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}. Without a CUDA device it exits
with 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 non-tensor; bf16 dense
WINDOW = (1024, 1920)
FLOW_UPSCALE = 2
D = 4
LEVEL_CHANNELS = {2: 32, 3: 64, 4: 96, 5: 128, 6: 196}
SMALL_TOL = 1e-4   # kernel vs plain path through both networks, outputs in [0, 1]
ORACLE_TOL = 1e-5  # card (f32, TF32 off) vs the TF-oracle fixtures


def log(*args):
    print(*args, flush=True)


def bf16_ok(got, want):
    """One bf16 rounding of f32 sums taken in another order: within one bf16
    ulp (2^-7 relative) plus 1e-5 for sums that cancel to ~0."""
    return bool(((got - want).abs() <= 1e-5 + 2.0**-7 * want.abs()).all())


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_time_ms(fn, reps=20, replays=5):
    """Device time of one call: `reps` calls captured in a CUDA graph and
    replayed, so the host's launch cost is not in the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, reps=replays, warmup=1) / reps


def cv_bound_ms(shape, dtype):
    """Least time for one cost volume: inputs read once, output written once
    over HBM bandwidth, or 2*81*C flops a pixel over the dtype's peak."""
    b, h, w, c = shape
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * w * c + b * h * w * (2 * D + 1) ** 2) * item
    flops = 2 * (2 * D + 1) ** 2 * c * b * h * w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from fisr_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all(["cost_volume"])
    log(f"[build] kernels built in {time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")
    for name, info in build.BUILD_LOG.items():
        for entry, spills, regs in build.ptxas_report(info["ptxas"]):
            log(f"[build] {name}: {entry}: {spills}; {regs}")
            if "mma_bf16" in entry and "0 bytes spill stores, 0 bytes spill loads" not in spills:
                raise AssertionError(f"{entry} spills registers: {spills}")


def phase_kernel():
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.ops.cost_volume import cost_volume as plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    hh, ww = (s * FLOW_UPSCALE for s in WINDOW)
    max_err, levels = 0.0, []
    for lvl, c in LEVEL_CHANNELS.items():
        shape = (2, hh >> lvl, ww >> lvl, c)
        row = {"level": lvl, "shape": list(shape)}
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(shape, device=dev, generator=g).to(dtype)
            b = torch.randn(shape, device=dev, generator=g).to(dtype)
            got = kernel.cost_volume_cuda(a, b, D).float()
            want = plain(a, b, D).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = (torch.allclose(got, want, rtol=1e-5, atol=1e-5) if dtype == torch.float32
                  else bf16_ok(got, want))
            if not ok:
                raise AssertionError(f"cost volume level {lvl} {dtype}: max |diff| {err}")
            max_err = max(max_err, err)
            tag = "f32" if dtype == torch.float32 else "bf16"
            bound, by = cv_bound_ms(shape, dtype)
            row.update({f"{tag}_err": err,
                        f"{tag}_ms": time_ms(lambda: kernel.cost_volume_cuda(a, b, D)),
                        f"{tag}_graph_ms": graph_time_ms(lambda: kernel.cost_volume_cuda(a, b, D)),
                        f"{tag}_plain_ms": time_ms(lambda: plain(a, b, D), reps=3, warmup=1),
                        f"{tag}_bound_ms": bound, f"{tag}_bound_by": by})
        levels.append(row)
        log(f"[kernel] {json.dumps(row)}")
    ragged = [((2, 37, 53, 3), 2), ((2, 37, 53, 3), 4), ((2, 9, 131, 196), 4),
              ((1, 5, 40, 20), 4), ((1, 1, 1, 1), 4)]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, d in ragged:
            a = torch.randn(shape, device=dev, generator=g).to(dtype)
            b = torch.randn(shape, device=dev, generator=g).to(dtype)
            got, want = kernel.cost_volume_cuda(a, b, d).float(), plain(a, b, d).float()
            err = (got - want).abs().max().item()
            ok = (torch.allclose(got, want, rtol=1e-5, atol=1e-5) if dtype == torch.float32
                  else bf16_ok(got, want))
            if not ok:
                raise AssertionError(f"ragged cost volume {shape} d={d} {dtype}: max |diff| {err}")
            max_err = max(max_err, err)
    a = torch.randn((1, 8, 12, 4), device=dev, generator=g, requires_grad=True)
    b = torch.randn((1, 8, 12, 4), device=dev, generator=g, requires_grad=True)
    gk = torch.autograd.grad((kernel.cost_volume_cuda(a, b, 2) ** 2).sum(), (a, b))
    gp = torch.autograd.grad((plain(a, b, 2) ** 2).sum(), (a, b))
    for x, y in zip(gk, gp):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    log(f"[kernel] all shapes and the gradient agree; max |diff| {max_err}")
    return max_err, levels


def phase_small(fisr, pwc):
    from fisr_tpu_torch.infer.video import make_fused_video_step
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.models import fisrnet, pwcnet

    dev = torch.device("cuda")
    frames = torch.from_numpy(synthetic_frames(3, 64, 64, seed=1)[None]).to(dev).float()
    outs = {}
    for impl in ("kernel", "plain"):
        before = kernel.LAUNCHES
        step = make_fused_video_step(pwcnet.PWCNetConfig(cost_volume_impl=impl))
        outs[impl] = step(fisr, pwc, frames)
        torch.cuda.synchronize()
        launches = kernel.LAUNCHES - before
        if launches != (10 if impl == "kernel" else 0):
            raise AssertionError(f"fused step ({impl}) made {launches} kernel launches")
    err = (outs["kernel"] - outs["plain"]).abs().max().item()
    if outs["kernel"].shape != (1, 128, 128, 9) or not err <= SMALL_TOL:
        raise AssertionError(f"fused step kernel vs plain: shape {tuple(outs['kernel'].shape)}, "
                             f"max |diff| {err} (bound {SMALL_TOL})")
    log(f"[small] fused step 64x64 f32, kernel vs plain: max |diff| {err} (bound {SMALL_TOL})")

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "tf_oracle")
    z = np.load(os.path.join(fix, "pwc_forward.npz"))
    x = torch.from_numpy(z["input"]).to(dev)
    with torch.no_grad():
        pred, _ = pwcnet.apply(pwc, x[:, 0], x[:, 1], pwc.cfg)
    e_pwc = float(np.abs(pred.cpu().numpy() - z["flow_pred"]).max())
    z = np.load(os.path.join(fix, "forward.npz"))
    with torch.no_grad():
        p3 = fisrnet.apply(fisr, torch.from_numpy(z["input"]).to(dev))[2]
    e_fisr = float(np.abs(p3.cpu().numpy() - z["pred_l3"]).max())
    if not (e_pwc <= ORACLE_TOL and e_fisr <= ORACLE_TOL):
        raise AssertionError(f"card vs TF oracle: PWC {e_pwc}, FISRnet {e_fisr} (bound {ORACLE_TOL})")
    log(f"[small] card vs TF-oracle fixtures: PWC flow_pred {e_pwc}, FISRnet pred_l3 {e_fisr} "
        f"(bound {ORACLE_TOL})")


def synthetic_frames(n, h, w, seed=0):
    """Smooth YUV-as-RGB u8 pattern moving a few px a frame, [n, h, w, 3]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy = rng.uniform(0.01, 0.03, 2)
    phase = rng.uniform(0, 6.28, 3)
    return np.stack([np.stack([127.5 + 100 * np.sin(fx * (xx - 3 * t) + fy * (yy - 2 * t) + phase[c])
                               for c in range(3)], -1) for t in range(n)]).astype(np.uint8)


def phase_full(fisr, pwc):
    from fisr_tpu_torch.data.png_io import read_png, write_png
    from fisr_tpu_torch.infer.video import make_fisr_window_fn, make_pair_fn, run_video_pipeline
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.models import fisrnet
    from fisr_tpu_torch.ops.conv import BF16

    dev = torch.device("cuda")
    h, w = WINDOW
    log(f"[full] FISRnet ch=64: {fisrnet.param_count(fisr)} params; PWC-Net lg-6-2: "
        f"{fisrnet.param_count(pwc)} params")
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "frames")
        os.makedirs(folder)
        frames = synthetic_frames(4, h, w)
        for i, fr in enumerate(frames):
            write_png(fr, os.path.join(folder, f"frame_{i:03d}.png"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.LAUNCHES = 0
        kernel.LAUNCHES_BY_VARIANT.update(mma_bf16=0, fma_f32=0)
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs = run_video_pipeline(fisr, pwc, folder, out_folder=os.path.join(tmp, "out"),
                                      policy=BF16, fused=True, flow_upscale=FLOW_UPSCALE,
                                      device=dev, verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernel.LAUNCHES
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if launches != 15 or kernel.LAUNCHES_BY_VARIANT != {"mma_bf16": 15, "fma_f32": 0}:
            raise AssertionError(f"main path made {launches} cost-volume launches "
                                 f"({kernel.LAUNCHES_BY_VARIANT}), want 15, all mma_bf16")
        if len(outs) != 6 or not all(os.path.exists(p) for p in outs):
            raise AssertionError(f"pipeline wrote {len(outs)} outputs: {outs}")
        for p in sorted(set(outs))[:2]:
            img = read_png(p)
            if img.shape != (2 * h, 2 * w, 3):
                raise AssertionError(f"{p}: shape {img.shape}")
        log(f"[full] pipeline: 4 frames -> {len(outs)} outputs of {2 * h}x{2 * w}, "
            f"{launches} cost-volume launches, {seconds:.2f} s (first call, PNG I/O "
            f"included), peak {peak_gib:.2f} GiB")

    pair_fn = make_pair_fn(pwc.cfg, BF16, FLOW_UPSCALE)
    window_fn = make_fisr_window_fn(BF16)
    d = [torch.from_numpy(f[None]).to(dev).float() for f in frames[:3]]
    with torch.inference_mode():
        p01 = pair_fn(pwc, d[0], d[1])
        p12 = pair_fn(pwc, d[1], d[2])
        win = torch.stack(d, dim=1)
        pred = window_fn(fisr, win, p01, p12)
        for name, t in (("flows", p01[0]), ("warps", p01[1]), ("prediction", pred)):
            if not torch.isfinite(t).all():
                raise AssertionError(f"non-finite {name}")
        if pred.shape != (1, 2 * h, 2 * w, 9):
            raise AssertionError(f"prediction shape {tuple(pred.shape)}")
        pair_ms = time_ms(lambda: pair_fn(pwc, d[0], d[1]), reps=5, warmup=1)
        window_ms = time_ms(lambda: window_fn(fisr, win, p01, p12), reps=5, warmup=1)
    log(f"[full] bf16 {h}x{w}: per pair {pair_ms:.3f} ms, per window (FISRnet stage) "
        f"{window_ms:.3f} ms, steady state {pair_ms + window_ms:.3f} ms per output window")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    max_err, levels = phase_kernel()
    from fisr_tpu_torch.convert import params

    # full-width deterministic weights (the TF-oracle generator), made once
    fisr = params.deterministic_fisrnet(ch=64, device="cuda")
    pwc = params.deterministic_pwcnet(device="cuda")
    phase_small(fisr, pwc)
    launches = phase_full(fisr, pwc)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"kernels": [{
        "name": "cost_volume", "route": "cuda", "variant": "mma_bf16",
        "source": "fisr_tpu_torch/csrc/cost_volume.cu",
        "replaces": "fisr_tpu/kernels/cost_volume_pallas.py:34",
        "launches": launches, "max_abs_err": max_err,
        # one frame pair's five levels (levels 6..2) in bf16, the main path's dtype
        "ms": sum(r["bf16_ms"] for r in levels),
        "graph_ms": sum(r["bf16_graph_ms"] for r in levels),
        "plain_ms": sum(r["bf16_plain_ms"] for r in levels),
        "bound_ms": sum(r["bf16_bound_ms"] for r in levels),
        "bound_by": "bytes" if all(r["bf16_bound_by"] == "bytes" for r in levels) else "operations",
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
