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
   (3 pairs x 5 levels, all of the bf16 variant), timed on its first call and
   again warm; then per-pair and per-window times and peak memory.
5. tiled  - the window stage at full width under fisr_grid None, 'auto'
   (must resolve to (4, 6), pad (0, 0)) and (2, 2): shape, finiteness, ms per
   window and peak memory of each plan (nothing is asserted about which is
   fastest), and the time of the weight fold of up_conv2x, anew and kept. In f32 at 128x128
   (TF32 off): tiled_apply against TiledRunner(mode='padded'), and
   fuse_input_glue=True against the composed apply, both within 1e-5; at
   160x160 the stale-halo shrink against the full ring, within 1e-6.
6. staged - run_video_pipeline(fused=False, grid=(2, 2)) on the same frames:
   6 outputs, 15 more cost-volume launches (all bf16), frames compared with
   the fused run's; with h5py on the machine the .flo and .mat artifacts are
   written and read back, without it the run says so.
7. eval   - the reference's test setting: one synthetic scene of 5 LR frames
   1080x1920 and 7 GT frames through TiledRunner(grid=(2, 2), boundary=32)
   (12 patches of 544x992x29 in one batch), PSNR and both SSIMs; ssim on the
   card against tests/fixtures/tf_oracle/ssim_tf.npz; a runner that returns
   the ground truth must score SSIM 1 and a PSNR above 120 dB.

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
EVAL_INPUT = (1080, 1920)  # the reference's test frames; (2, 2) tiling crops them to 1024x1920
FLOW_UPSCALE = 2
D = 4
LEVEL_CHANNELS = {2: 32, 3: 64, 4: 96, 5: 128, 6: 196}
SMALL_TOL = 1e-4   # kernel vs plain path through both networks, outputs in [0, 1]
ORACLE_TOL = 1e-5  # card (f32, TF32 off) vs the TF-oracle fixtures
TILED_TOL = 1e-5   # device tiling vs host padded tiling, fused glue vs composed (f32)
SHRINK_TOL = 1e-6  # stale-halo shrink vs the full ring (f32): equal unless cuDNN changes algorithm
# staged (exact (2, 2) tiling) vs fused (full frame) output frames, bf16, in u8
# counts: the halo truncates the receptive field and another conv extent may
# take another bf16 summation order
STAGED_MAX_U8, STAGED_MEAN_U8 = 4, 0.03


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


def reset_launches(kernel):
    kernel.LAUNCHES = 0
    kernel.LAUNCHES_BY_VARIANT.update(mma_bf16=0, fma_f32=0)


def require_launches(kernel, what, want=15):
    if kernel.LAUNCHES != want or kernel.LAUNCHES_BY_VARIANT != {"mma_bf16": want, "fma_f32": 0}:
        raise AssertionError(f"{what} made {kernel.LAUNCHES} cost-volume launches "
                             f"({kernel.LAUNCHES_BY_VARIANT}), want {want}, all mma_bf16")


def phase_full(fisr, pwc, tmp):
    from fisr_tpu_torch.data.png_io import read_png, write_png
    from fisr_tpu_torch.infer.video import make_fisr_window_fn, make_pair_fn, run_video_pipeline
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.models import fisrnet
    from fisr_tpu_torch.ops.conv import BF16

    dev = torch.device("cuda")
    h, w = WINDOW
    log(f"[full] FISRnet ch=64: {fisrnet.param_count(fisr)} params; PWC-Net lg-6-2: "
        f"{fisrnet.param_count(pwc)} params")
    folder = os.path.join(tmp, "scene1")
    os.makedirs(folder)
    frames = synthetic_frames(4, h, w)
    for i, fr in enumerate(frames):
        write_png(fr, os.path.join(folder, f"frame_{i:03d}.png"))
    walls = []
    for call in ("first", "second"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kernel)
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs = run_video_pipeline(fisr, pwc, folder, out_folder=os.path.join(tmp, "fused"),
                                      policy=BF16, fused=True, flow_upscale=FLOW_UPSCALE,
                                      device=dev, verbose=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = kernel.LAUNCHES
        require_launches(kernel, f"main path ({call} call)")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if len(outs) != 6 or not all(os.path.exists(p) for p in outs):
        raise AssertionError(f"pipeline wrote {len(outs)} outputs: {outs}")
    for p in sorted(set(outs))[:2]:
        img = read_png(p)
        if img.shape != (2 * h, 2 * w, 3):
            raise AssertionError(f"{p}: shape {img.shape}")
    log(f"[full] pipeline: 4 frames -> {len(outs)} outputs of {2 * h}x{2 * w}, "
        f"{launches} cost-volume launches, {walls[0]:.2f} s (first call, PNG I/O "
        f"included), {walls[1]:.2f} s (second call), peak {peak_gib:.2f} GiB")

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
    return launches, folder


def phase_tiled(fisr, pwc, frames_u8):
    from fisr_tpu_torch.infer.device import tiled_apply
    from fisr_tpu_torch.infer.tiled import TiledRunner
    from fisr_tpu_torch.infer.video import make_fisr_window_fn, make_pair_fn, resolve_fisr_plan
    from fisr_tpu_torch.models import fisrnet
    from fisr_tpu_torch.ops.conv import (BF16, F32, _fold_up_conv_weights, conv2d,
                                         conv_in_fused)
    from fisr_tpu_torch.ops.resize import downsample_int

    dev = torch.device("cuda")
    h, w = WINDOW
    if resolve_fisr_plan("auto", h, w, BF16) != ((4, 6), (0, 0)):
        raise AssertionError(f"'auto' at {h}x{w} resolved to {resolve_fisr_plan('auto', h, w, BF16)}")
    d = [torch.from_numpy(f[None]).to(dev).float() for f in frames_u8[:3]]
    pair_fn = make_pair_fn(pwc.cfg, BF16, FLOW_UPSCALE)
    plans = {}
    with torch.inference_mode():
        p01, p12 = pair_fn(pwc, d[0], d[1]), pair_fn(pwc, d[1], d[2])
        win = torch.stack(d, dim=1)
        preds = {}
        for spec in (None, "auto", (2, 2)):
            fn = make_fisr_window_fn(BF16, fisr_grid=spec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pred = fn(fisr, win, p01, p12)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            if pred.shape != (1, 2 * h, 2 * w, 9) or not torch.isfinite(pred).all():
                raise AssertionError(f"window under fisr_grid={spec}: shape {tuple(pred.shape)} "
                                     "or non-finite values")
            ms = time_ms(lambda: fn(fisr, win, p01, p12), reps=5, warmup=1)
            preds[spec] = (pred * 255).to(torch.uint8).short()
            plans[str(spec)] = {"ms": ms, "peak_gib": peak}
            log(f"[tiled] bf16 {h}x{w} window, fisr_grid={spec}: {ms:.3f} ms, peak {peak:.2f} GiB")
        for spec in ("auto", (2, 2)):
            diff = (preds[spec] - preds[None]).abs().float()
            log(f"[tiled] fisr_grid={spec} vs full frame, u8 counts: max {int(diff.max())}, "
                f"mean {diff.mean().item():.4f}")
        # the weight fold of up_conv2x (level 3's dec1 and dec0), run on every call
        for name in ("level_1", "level_0"):
            p = fisr.level_3.dec[name].resize
            ms = time_ms(lambda: _fold_up_conv_weights(p.weight).to(torch.bfloat16), reps=20)
            log(f"[tiled] up_conv2x weight fold, level_3.dec.{name} {tuple(p.weight.shape)}: "
                f"{ms:.4f} ms a call")

        # the fused input glue at the 'auto' plan's batch (24 patches of 320x384):
        # cuDNN on the strided, dilated 29-channel conv against the composition
        xb = torch.rand((24, 320, 384, 29), device=dev, generator=torch.Generator(
            device=dev).manual_seed(3)).to(torch.bfloat16)
        for lvl, k in (("level_1", 4), ("level_2", 2)):
            c_in = getattr(fisr, lvl).enc["level_0"].conv_in
            extra = None if k == 4 else torch.rand((24, 160, 192, 9), device=dev).to(torch.bfloat16)

            def composed():
                sub = downsample_int(xb, k)
                return conv2d(c_in, sub if extra is None else torch.cat([sub, extra], -1), BF16)

            fused_ms = time_ms(lambda: conv_in_fused(c_in, xb, extra, BF16, k), reps=10)
            composed_ms = time_ms(composed, reps=10)
            log(f"[tiled] conv_in of {lvl} on [24, 320, 384, 29] bf16, stride {k}: conv_in_fused "
                f"{fused_ms:.3f} ms, subsample + concat + conv {composed_ms:.3f} ms")

        # f32 at a small size: the device tiling and the fused glue leave the function alone
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.rand((1, 128, 128, 29), device=dev, generator=g)
        got = tiled_apply(fisr, x, (2, 2), 32, 2, F32)
        host = TiledRunner(fisr, grid=(2, 2), boundary=32, policy=F32, mode="padded", device=dev)
        e_tiled = float(np.abs(got.cpu().numpy() - host(x.cpu().numpy())).max())
        plain = fisrnet.apply(fisr, x, 2, F32)[2]
        glued = fisrnet.apply(fisr, x, 2, F32, fuse_input_glue=True)[2]
        e_glue = (plain - glued).abs().max().item()
        # the stale-halo shrink against the full ring on the pixels it keeps
        x = torch.rand((1, 160, 160, 29), device=dev, generator=g)
        ring = fisrnet.apply(fisr, x, 2, F32)[2][:, 64:-64, 64:-64]
        shrunk = fisrnet.apply(fisr, x, 2, F32, final_stale_halo=32)[2][:, 16:-16, 16:-16]
        e_shrink = (ring - shrunk).abs().max().item()
    if not (e_tiled <= TILED_TOL and e_glue <= TILED_TOL and e_shrink <= SHRINK_TOL):
        raise AssertionError(f"f32: tiled_apply vs host padded tiling {e_tiled}, fused glue vs "
                             f"composed {e_glue} (bound {TILED_TOL}), stale-halo shrink vs full "
                             f"ring {e_shrink} (bound {SHRINK_TOL})")
    log(f"[tiled] f32 128x128: tiled_apply vs TiledRunner(padded) {e_tiled}, fuse_input_glue vs "
        f"composed {e_glue} (bound {TILED_TOL}); 160x160: stale-halo shrink vs full ring on "
        f"retained pixels {e_shrink} (bound {SHRINK_TOL}; 0 = bit-equal)")
    return plans


def have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def phase_staged(fisr, pwc, folder, tmp):
    from fisr_tpu_torch.data import flo, matio
    from fisr_tpu_torch.data.png_io import read_png
    from fisr_tpu_torch.infer.video import run_video_pipeline
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.ops.conv import BF16

    h, w = WINDOW
    artifacts = have_h5py()
    if not artifacts:
        log("[staged] this machine has no h5py: write_artifacts=False, the .mat round trip "
            "was not exercised on the card (the CPU tests cover it)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernel)
    t0 = time.perf_counter()
    with torch.inference_mode():
        outs = run_video_pipeline(fisr, pwc, folder, out_folder=os.path.join(tmp, "staged"),
                                  grid=(2, 2), boundary=32, policy=BF16,
                                  write_artifacts=artifacts, fused=False,
                                  flow_upscale=FLOW_UPSCALE, device="cuda", verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require_launches(kernel, "staged path")
    launches = kernel.LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if len(outs) != 6:
        raise AssertionError(f"staged pipeline wrote {len(outs)} outputs")
    worst, means = 0, []
    for name in sorted({os.path.basename(p) for p in outs}):
        a = read_png(os.path.join(tmp, "staged", name.replace("pred_", "pred_YUV_")))
        b = read_png(os.path.join(tmp, "fused", name.replace("pred_", "pred_YUV_")))
        if a.shape != (2 * h, 2 * w, 3):
            raise AssertionError(f"staged {name}: shape {a.shape}")
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        worst, means = max(worst, int(diff.max())), means + [float(diff.mean())]
    if worst > STAGED_MAX_U8 or max(means) > STAGED_MEAN_U8:
        raise AssertionError(f"staged vs fused frames: max {worst} u8 counts, mean {max(means)} "
                             f"(bounds {STAGED_MAX_U8}, {STAGED_MEAN_U8})")
    log(f"[staged] pipeline: 4 frames -> {len(outs)} outputs, {launches} cost-volume launches, "
        f"{seconds:.2f} s (write_artifacts={artifacts}), peak {peak_gib:.2f} GiB; YUV frames vs "
        f"the fused run's: max {worst} u8 counts, worst frame mean {max(means):.4f} "
        f"(bounds {STAGED_MAX_U8}, {STAGED_MEAN_U8})")
    if artifacts:
        flows = flo.read_flo_5dim(os.path.join(folder, "scene1_test_ss1_fr4.flo"))
        warps = matio.read_warp_mat(os.path.join(folder, "scene1_ss1_fr4_warp.mat"))
        if flows.shape != (3, 2, h, w, 2) or warps.shape != (3, 2, h, w, 3) or not (
                np.isfinite(flows).all() and 0.0 <= warps.min() and warps.max() <= 1.0):
            raise AssertionError(f"artifacts: flows {flows.shape}, warps {warps.shape}, warp range "
                                 f"[{warps.min()}, {warps.max()}]")
        log(f"[staged] artifacts read back: .flo {flows.shape}, max |flow| "
            f"{np.abs(flows).max():.3f} px; .mat {warps.shape} in [0, 1]")
    return launches


def phase_eval(fisr, tmp):
    from fisr_tpu_torch.data import flo, matio
    from fisr_tpu_torch.data.png_io import write_png
    from fisr_tpu_torch.infer import evaluate
    from fisr_tpu_torch.infer.tiled import TiledRunner
    from fisr_tpu_torch.ops import metrics
    from fisr_tpu_torch.ops.conv import BF16

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    fix = os.path.join(root, "tests", "fixtures", "tf_oracle")
    with open(os.path.join(fix, "ssim_manifest.json")) as f:
        cases = json.load(f)["cases"]
    fx = np.load(os.path.join(fix, "ssim_tf.npz"))
    e_ssim = max(float(np.abs(metrics.ssim(
        torch.from_numpy(fx[f"{c['name']}_a"]).to(dev), torch.from_numpy(fx[f"{c['name']}_b"]).to(dev),
        max_val=c["max_val"]).double().cpu().numpy() - fx[f"{c['name']}_ssim"]).max()) for c in cases)
    if not e_ssim <= 1e-4:
        raise AssertionError(f"ssim on the card vs tf.image.ssim: {e_ssim} (bound 1e-4)")
    log(f"[eval] ssim on the card vs ssim_tf.npz: max |diff| {e_ssim} (bound 1e-4)")

    h0, w0 = EVAL_INPUT
    hr = synthetic_frames(9, 2 * h0, 2 * w0, seed=3)
    lr, gt = hr[::2, ::2, ::2], hr[1:8]
    lr_dir, gt_dir = os.path.join(tmp, "eval_lr"), os.path.join(tmp, "eval_gt")
    os.makedirs(lr_dir)
    os.makedirs(gt_dir)
    for i, fr in enumerate(lr):
        write_png(fr, os.path.join(lr_dir, f"LR_{i + 1:05d}.png"))
    for i, fr in enumerate(gt):
        write_png(fr, os.path.join(gt_dir, f"HR_{i + 1:05d}.png"))
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:h0, 0:w0].astype(np.float32)
    flow = np.stack([np.stack([a * np.sin(0.01 * xx + p), a * np.cos(0.013 * yy + p)], -1)
                     for a, p in zip(rng.uniform(-6, 6, 8), rng.uniform(0, 6.28, 8))])[None]
    flow = flow.astype(np.float32)                                  # [1, 8, h, w, 2] px
    warp = np.repeat(lr[:4], 2, axis=0)[None].astype(np.float32)    # [1, 8, h, w, 3] in [0, 255]

    # 12 patches of 544x992: level 3's widest tensors are the heads' conv1
    # outputs, 12*544*992*256 bf16 elements = 3.3 GB each
    patches_px = 12 * 544 * 992
    log(f"[eval] reckoned: 12 patches of 544x992x29 in one bf16 batch, {patches_px / 1e6:.2f} M px "
        f"against the full-frame window's {WINDOW[0] * WINDOW[1] / 1e6:.2f} M; the widest tensor "
        f"(conv1 of a head, 256 channels) is {patches_px * 256 * 2 / 2**30:.2f} GiB")
    runner = TiledRunner(fisr, grid=(2, 2), boundary=32, policy=BF16, mode="exact", device=dev)
    kw = dict(out_dir=os.path.join(tmp, "eval_out"), input_size=(h0, w0), verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = {}
    for impl in ("gaussian", "pil"):
        if have_h5py():
            flow_path, warp_path = os.path.join(tmp, "eval.flo"), os.path.join(tmp, "eval_warp.mat")
            if impl == "gaussian":
                flo.write_flo_5dim(flow, flow_path)
                matio.write_warp_mat(warp, warp_path)
            results[impl] = evaluate.evaluate_test_set(runner, lr_dir, gt_dir, flow_path, warp_path,
                                                       ssim_impl=impl, **kw)
        else:
            results[impl] = evaluate.evaluate_scenes(runner, lr_dir, gt_dir, flow, warp / 255.0,
                                                     ssim_impl=impl, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for impl, res in results.items():
        vals = (res.psnr_vfi_sr, res.psnr_sr, res.ssim_vfi_sr, res.ssim_sr, res.sec_per_frame)
        if res.n_frames != 7 or not np.isfinite(vals).all() or not (
                -1 <= res.ssim_vfi_sr <= 1 and -1 <= res.ssim_sr <= 1):
            raise AssertionError(f"eval ({impl}): {res}")
        log(f"[eval] TiledRunner (2, 2) exact, bf16, ssim_impl={impl}: {res}")
    if len(os.listdir(kw["out_dir"])) != 7:
        raise AssertionError(f"eval wrote {os.listdir(kw['out_dir'])}")
    log(f"[eval] through {'evaluate_test_set (.flo/.mat files)' if have_h5py() else 'evaluate_scenes (no h5py here)'}: "
        f"two passes in {seconds:.2f} s, peak {peak_gib:.2f} GiB")

    class TruthRunner:
        """Returns the ground truth for each window: scoring must then be perfect."""
        grid, sf, device = (2, 2), 2, dev

        def __call__(self, inp):
            hh = 2 * inp.shape[1]
            if not inp.any():  # the warm-up call
                return np.zeros((3, hh, 2 * inp.shape[2], 9), np.float32)
            return np.stack([np.concatenate(list(gt[2 * i:2 * i + 3, :hh]), 2)
                             for i in range(3)]).astype(np.float32) / 255.0

    res = evaluate.evaluate_scenes(TruthRunner(), lr_dir, gt_dir, flow, warp / 255.0,
                                   input_size=(h0, w0), verbose=False)
    if not (res.psnr_vfi_sr > 120 and res.psnr_sr > 120 and abs(res.ssim_vfi_sr - 1) < 1e-6
            and abs(res.ssim_sr - 1) < 1e-6 and res.n_frames == 7):
        raise AssertionError(f"ground truth scored against itself: {res}")
    log(f"[eval] ground truth against itself: PSNR {res.psnr_vfi_sr:.1f} / {res.psnr_sr:.1f} dB, "
        f"SSIM {res.ssim_vfi_sr:.7f} / {res.ssim_sr:.7f}")
    return results["gaussian"].sec_per_frame, peak_gib


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
    with tempfile.TemporaryDirectory() as tmp:
        launches, folder = phase_full(fisr, pwc, tmp)
        phase_tiled(fisr, pwc, synthetic_frames(4, *WINDOW))
        launches_staged = phase_staged(fisr, pwc, folder, tmp)
        phase_eval(fisr, tmp)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"kernels": [{
        "name": "cost_volume", "route": "cuda", "variant": "mma_bf16",
        "source": "fisr_tpu_torch/csrc/cost_volume.cu",
        "replaces": "fisr_tpu/kernels/cost_volume_pallas.py:34",
        "launches": launches, "launches_staged": launches_staged, "max_abs_err": max_err,
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
