#!/usr/bin/env python3
"""Drive the fisr_tpu_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. build  - nvcc builds every kernel of the fused video path from
   fisr_tpu_torch/csrc/ (one nvcc per source, all started together); ptxas
   must report no spills for any of its kernels (bf16 mma.sync, f32 FMA,
   backward).
2. kernel - the cost-volume kernels (bf16: mma.sync, f32: FMA) against the
   plain PyTorch version on the card at the five PWC-Net level shapes of a
   1024x1920 window (B=2, d=4), at ragged shapes (d=2 and 4, odd W and H,
   C=3, 20, 196), and the gradient; the backward kernel against the plain
   backward (ops/cost_volume.cost_volume_backward) at the ragged shapes, f32
   and bf16. At the level shapes the kernel is timed
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
   serve  - the serving CLI's service (cli/serve.build_service at its
   defaults: 1024x1920, bf16, fisr_grid 'auto', flow_scale 2, the generator's
   full-width weights) behind infer/daemon.make_server on the loopback, over
   urllib: /healthz, /v1/info, /metrics, 401 without the bearer token, 413
   for an announced body over the limit, 400 for a wrong frame size; one
   /v1/window (10 launches, equal to FISRService.window, within 1 u8 count of
   the fused step quantized by hand); one stream of 4 frames (202, 202, 200,
   200; 3 pair stages; 5 launches a steady frame; its first window within the
   JAX test's bounds of /v1/window); one ?colorspace=rgb window against
   yuv2rgb_matlab_u8 of the YUV one. Times with their spread: the service's
   window and steady stream frame (median of 5), the HTTP round trips with
   PNG encode and decode (median of 3); the warm-up's memory checks; the
   peak. Then a sweep of (1, 1), (2, 2), (4, 6) into a tune cache in a
   temporary directory, and fisr_grid 'tuned' must resolve to its winner.
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
   (12 patches of 544x992x29 in one batch), PSNR and SSIM; ssim on the
   card against tests/fixtures/tf_oracle/ssim_tf.npz; a runner that returns
   the ground truth must score SSIM 1 and a PSNR above 120 dB under both
   SSIM scorers (the card's Gaussian one and the host's PIL one).
8. train  - train/loop.fit at full width (FISRnet ch=64) on
   data/synth.synthetic_store(h=96, w=96), batch 8, val batch 2, bf16: one
   epoch of 6 steps with validation, the TensorBoard log and a checkpoint; a
   second fit call resumes from it and must return the saved step and
   parameters bit for bit. The first step's ten loss terms in f32 on the card
   against the same step on the CPU (two samples, rtol 1e-4); repeated steps
   on one batch must lower total_loss. Prints ms per step in f32 and bf16,
   samples/s and peak memory.
9. pwc_train - train/pwc_trainer.make_pwc_train_step at full width (PWC-Net
   lg-6-2) on FlowDataset.synthetic_textured, batch 8 of 256x448, multiscale
   loss: 5 cost-volume launches a step, fma_f32 under F32 and mma_bf16 under
   BF16, and 5 backward launches (bwd_f32 / bwd_bf16); each kernel against
   its plain version at exactly the shapes and dtypes those launches had
   ([8, 256>>l, 448>>l, C], down to 4x7); in f32 the parameter gradients
   through the kernels against those through the plain version and its
   autograd (1e-5 of the largest gradient); the loss must fall over repeated
   steps on one batch; make_pwc_eval_step must give a finite EPE. Prints ms
   per step and, of it, the time inside the cost volume's backward per level,
   and times the backward alone at the five level shapes: the kernel's
   graph_ms, card busy time and its caller's wait, against the card busy
   time, kernel count and caller's wait of the plain version's autograd (the
   baseline). Then pwc_fit for 2 steps with a validation round, the flow
   panel and a checkpoint (20 launches, all mma_bf16; 10 bwd_bf16), and
   pwc_eval_report on the result (finite rows, .flo and PNG predictions).
10. joint - train/joint.make_joint_train_step on
   data/synth.synthetic_video_windows(h=96, w=96), B=2, upscale=2: with both
   optimizers (10 launches a step = 2 flow calls x 5 levels, and 10 backward
   launches; both models move; joint_loss falls on one batch), then with the
   flow model frozen (10 launches, no backward launch, only FISRnet moves);
   the kernels against their plain versions at the shapes those launches had
   ([4, 192>>l, 192>>l, C], down to 3x3), f32 and bf16. Prints ms per step
   and peak memory.
11. weights - the full-width FISRnet and PWC-Net exported as TF1 bundles
   (convert/tensor_bundle.write_bundle, with crc32c); the CLI's
   --fisr_tf_ckpt / --pwc_tf_ckpt build both on the card, and convert.cli
   --ckpt (the PWC-Net one with --verify-crc) into checkpoints of the port
   that the CLI's restore route reads: every state-dict tensor bit-equal to
   the originals. Prints each bundle's MB and read time.
12. trained - with tensorstore on the machine: the repo's trained PWC-Net
   (checkpoint_dir/pwcnet, an orbax store) through the CLI's default
   restore, the fused main path on it at 1024x1920 bf16 (15 launches, all
   mma_bf16), the steady window's time and spread, and an f32 flow of a
   256x448 crop on the card against the same module on the CPU (1e-4 of max
   |flow|). Without tensorstore (the card's machine has none): the reader
   must refuse an orbax step with the ImportError that names the
   convert.cli --orbax route, and the line says the route was not exercised.
13. prepare - cli/prepare flow-from-pngs on one scene of 5 synthetic
   1024x1920 PNG frames, f32, with the trained PWC-Net where phase 12 ran,
   else the converted deterministic one: exactly 20 launches at ss=1 (4
   pairs x 5 levels) and 10 at ss=2, all fma_f32, the kernel against the
   plain version at their shapes; the .flo bit-equal to
   flows_for_sequences, warps_for_sequences finite; ms a pair.

Prints the card's name and power limit, a {"kernels": [...]} line (the
bf16 and f32 forward kernels and the backward kernel; the bf16 entry's
`launches_serve` counts a /v1/window and a steady stream frame,
`launches_trained` the trained phase's run or null; the f32 entry's
`launches_prepare` the prepare phase's runs), and as its
last line {"ok": true, "device": {...}}. Without a CUDA device it exits
with 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
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
TRAIN_TOL = 1e-4   # first train step's loss terms, card (f32, TF32 off) vs CPU, relative
GRAD_TOL = 1e-5    # PWC-Net parameter gradients, kernel vs plain forward, of the largest gradient
TRAIN_PATCH = 96   # the reference's training patches
PWC_CROP = (256, 448)  # upstream tfoptflow's training crop
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


def cv_bwd_bound_ms(shape, dtype):
    """Least time for one backward: g, c1 and c2 read once, dc1 and dc2
    written once, B*H*W*(81 + 4C) values; or 4*81*C flops a pixel."""
    b, h, w, c = shape
    item = torch.tensor([], dtype=dtype).element_size()
    nn = (2 * D + 1) ** 2
    nbytes = b * h * w * (nn + 4 * c) * item
    flops = 4 * nn * c * b * h * w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_cost_volume(kernel, plain, shape, d, dtype, g):
    """The kernel against the plain version on random card tensors of `shape`:
    (max |diff|, c1, c2), or raises. f32 within 1e-5, bf16 within `bf16_ok`."""
    a = torch.randn(shape, device="cuda", generator=g).to(dtype)
    b = torch.randn(shape, device="cuda", generator=g).to(dtype)
    got, want = kernel.cost_volume_cuda(a, b, d).float(), plain(a, b, d).float()
    err = (got - want).abs().max().item()
    ok = (torch.allclose(got, want, rtol=1e-5, atol=1e-5) if dtype == torch.float32
          else bf16_ok(got, want))
    if not ok:
        raise AssertionError(f"cost volume {tuple(shape)} d={d} {dtype}: max |diff| {err}")
    return err, a, b


def check_backward(kernel, shape, d, dtype, g):
    """The backward kernel against the plain backward (cost_volume_backward)
    on random card tensors of `shape`: max |diff| over both gradients, or
    raises. f32 within 1e-5, bf16 within `bf16_ok`."""
    from fisr_tpu_torch.ops.cost_volume import cost_volume_backward

    a = torch.randn(shape, device="cuda", generator=g).to(dtype)
    b = torch.randn(shape, device="cuda", generator=g).to(dtype)
    grad = torch.randn(tuple(shape[:3]) + ((2 * d + 1) ** 2,), device="cuda",
                       generator=g).to(dtype)
    got = kernel.cost_volume_backward_cuda(a, b, grad, d)
    want = cost_volume_backward(a, b, grad, d)
    err = 0.0
    for x, y in zip(got, want):
        x, y = x.float(), y.float()
        err = max(err, (x - y).abs().max().item())
        ok = (torch.allclose(x, y, rtol=1e-5, atol=1e-5) if dtype == torch.float32
              else bf16_ok(x, y))
        if not ok:
            raise AssertionError(f"cost-volume backward {tuple(shape)} d={d} {dtype}: "
                                 f"max |diff| {err}")
    return err


@contextlib.contextmanager
def recorded_launches(kernel):
    """Lists (shape, search range, dtype) of every cost-volume launch made
    inside the block, in order: forward launches, and backward launches."""
    seen, seen_bwd = [], []
    orig, orig_bwd = kernel._launch, kernel._launch_backward

    def launch(c1, c2, d):
        seen.append((tuple(c1.shape), d, c1.dtype))
        return orig(c1, c2, d)

    def launch_backward(c1, c2, g, d, *need):
        seen_bwd.append((tuple(c1.shape), d, c1.dtype))
        return orig_bwd(c1, c2, g, d, *need)

    kernel._launch, kernel._launch_backward = launch, launch_backward
    try:
        yield seen, seen_bwd
    finally:
        kernel._launch, kernel._launch_backward = orig, orig_bwd


def check_recorded(kernel, seen, want_shapes, what, seed, backward=False):
    """A training path's launches, as `recorded_launches` listed them, must be
    at `want_shapes`; the kernel (the backward kernel with `backward`) is then
    held against its plain version at each of those shapes in the dtype the
    path gave it. Returns the largest |diff|. The comparisons' own launches
    come after the path's were counted."""
    from fisr_tpu_torch.ops.cost_volume import cost_volume as plain

    if sorted(s for s, _, _ in seen) != sorted(want_shapes):
        raise AssertionError(f"{what} launched the cost-volume {'backward ' * backward}at "
                             f"{[s for s, _, _ in seen]}, want {want_shapes}")
    g = torch.Generator(device="cuda").manual_seed(seed)
    if backward:
        return max(check_backward(kernel, shape, d, dtype, g)
                   for shape, d, dtype in dict.fromkeys(seen))
    return max(check_cost_volume(kernel, plain, shape, d, dtype, g)[0]
               for shape, d, dtype in dict.fromkeys(seen))


def phase_build():
    from fisr_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all(["cost_volume"])
    log(f"[build] kernels built in {time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")
    for name, info in build.BUILD_LOG.items():
        for entry, spills, regs in build.ptxas_report(info["ptxas"]):
            log(f"[build] {name}: {entry}: {spills}; {regs}")
            if "0 bytes spill stores, 0 bytes spill loads" not in spills:
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
            err, a, b = check_cost_volume(kernel, plain, shape, D, dtype, g)
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
            max_err = max(max_err, check_cost_volume(kernel, plain, shape, d, dtype, g)[0])
    # the backward kernel against the plain backward at the ragged shapes
    bwd_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, d in ragged:
            bwd_err = max(bwd_err, check_backward(kernel, shape, d, dtype, g))
    a = torch.randn((1, 8, 12, 4), device=dev, generator=g, requires_grad=True)
    b = torch.randn((1, 8, 12, 4), device=dev, generator=g, requires_grad=True)
    gk = torch.autograd.grad((kernel.cost_volume_cuda(a, b, 2) ** 2).sum(), (a, b))
    gp = torch.autograd.grad((plain(a, b, 2) ** 2).sum(), (a, b))
    for x, y in zip(gk, gp):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    log(f"[kernel] all shapes and the gradient agree; max |diff| {max_err}; the backward "
        f"kernel against the plain backward at the ragged shapes, f32 and bf16: max |diff| "
        f"{bwd_err}")
    return max_err, levels, bwd_err


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
    kernel.BACKWARD_LAUNCHES = 0
    kernel.BACKWARD_LAUNCHES_BY_VARIANT.update(bwd_f32=0, bwd_bf16=0)


def require_backward(kernel, what, want, variant):
    by_variant = {v: (want if v == variant else 0) for v in kernel.BACKWARD_LAUNCHES_BY_VARIANT}
    if kernel.BACKWARD_LAUNCHES != want or kernel.BACKWARD_LAUNCHES_BY_VARIANT != by_variant:
        raise AssertionError(f"{what} made {kernel.BACKWARD_LAUNCHES} cost-volume backward "
                             f"launches ({kernel.BACKWARD_LAUNCHES_BY_VARIANT}), want {want}, "
                             f"all {variant}")


def require_launches(kernel, what, want=15, variant="mma_bf16"):
    by_variant = {v: (want if v == variant else 0) for v in kernel.LAUNCHES_BY_VARIANT}
    if kernel.LAUNCHES != want or kernel.LAUNCHES_BY_VARIANT != by_variant:
        raise AssertionError(f"{what} made {kernel.LAUNCHES} cost-volume launches "
                             f"({kernel.LAUNCHES_BY_VARIANT}), want {want}, all {variant}")


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


def spread_ms(seconds):
    """{median, min, max} of a list of seconds, in ms."""
    ms = 1e3 * np.asarray(seconds)
    return {"median_ms": float(np.median(ms)), "min_ms": float(ms.min()),
            "max_ms": float(ms.max()), "n": len(ms)}


def u8_diff(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float(d.mean())


def phase_serve(tmp):
    """The serving CLI's service at its defaults behind the HTTP server,
    driven over the loopback; then a short tune into a cache at `tmp`."""
    import socket
    import threading
    import urllib.error
    import urllib.request

    from fisr_tpu_torch.cli import serve
    from fisr_tpu_torch.infer import autotune
    from fisr_tpu_torch.infer.daemon import _yuv_from, pack_frames, unpack_frames
    from fisr_tpu_torch.infer.video import make_fused_video_step, resolve_fisr_plan
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.ops.color import yuv2rgb_matlab_u8
    from fisr_tpu_torch.ops.conv import BF16

    h, w = WINDOW
    token = "smoke-token"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    args = serve.build_parser().parse_args(
        ["--height", str(h), "--width", str(w), "--deterministic_weights", "--host", "127.0.0.1",
         "--port", "0", "--auth_token", token])
    if (args.dtype, args.fisr_grid, args.flow_scale) != ("bfloat16", "auto", 2):
        raise AssertionError(f"serving defaults changed: {args}")
    t0 = time.perf_counter()
    service = serve.build_service(args)
    for stage, info in service.memory_checks.items():
        log(f"[serve] warm-up {stage}: need {info['need_bytes'] / 2**30:.3f} GiB, limit "
            f"{info['limit_bytes'] / 2**30:.3f} GiB, budget {info['budget_bytes'] / 2**30:.3f} GiB")
    log(f"[serve] weights, bf16 cast and warm-up: {time.perf_counter() - t0:.2f} s")
    server = serve.make_http_server(service, args)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"

    def call(path, payload=None, method=None, auth=True):
        headers = {"Authorization": f"Bearer {token}"} if auth else {}
        req = urllib.request.Request(url + path, data=payload, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def expect(what, got, want):
        if got != want:
            raise AssertionError(f"[serve] {what}: got {got}, want {want}")

    try:
        # the smaller requests
        code, body = call("/healthz", auth=False)
        expect("/healthz", (code, json.loads(body)), (200, {"status": "ok"}))
        expect("/v1/info without the token", call("/v1/info", auth=False)[0], 401)
        code, body = call("/v1/info")
        info = json.loads(body)
        expect("/v1/info", (code, info["frame"], info["dtype"], info["fisr_grid"], info["device"]),
               (200, [h, w], "bfloat16", "auto", torch.cuda.get_device_name(0)))
        code, body = call("/metrics")
        expect("/metrics", (code, "fisr_windows_total 0" in body.decode()), (200, True))
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            # a body over the limit is refused before it is sent
            s.sendall((f"POST /v1/window HTTP/1.1\r\nHost: x\r\nAuthorization: Bearer {token}"
                       f"\r\nContent-Length: {args.max_request_bytes + 1}\r\n\r\n").encode())
            expect("oversized body", s.recv(4096)[:12], b"HTTP/1.1 413")
        code, body = call("/v1/window", pack_frames(list(synthetic_frames(3, 32, 64))))
        expect("wrong frame size", (code, b"compiled for" in body), (400, True))

        # one window: 2 pairs x 5 levels
        frames = list(synthetic_frames(4, h, w, seed=3))
        reset_launches(kernel)
        code, body = call("/v1/window", pack_frames(frames[:3]))
        expect("/v1/window", code, 200)
        require_launches(kernel, "/v1/window", want=10)
        launches = {"window": kernel.LAUNCHES}
        window = unpack_frames(body)
        for a, b in zip(window, service.window(frames[:3])):
            if a.shape != (2 * h, 2 * w, 3) or not np.array_equal(a, b):
                raise AssertionError("[serve] /v1/window differs from FISRService.window")
        step = make_fused_video_step(service.pwc_params.cfg, BF16, 2, 2, "auto")
        with torch.inference_mode():
            stack = torch.stack([torch.from_numpy(f).cuda().float() for f in frames[:3]])[None]
            pred = step(service.fisr_params, service.pwc_params, stack)[0]
            hand = torch.round(pred.float() * 255).clamp(0, 255).to(torch.uint8).cpu().numpy()
        hand_diff = [u8_diff(a, hand[..., 3 * s:3 * s + 3]) for s, a in enumerate(window)]
        if max(d[0] for d in hand_diff) > 1:
            raise AssertionError(f"[serve] /v1/window vs the fused step: {hand_diff}")

        # one stream of 4 frames: 202, 202, then a window a frame, 1 pair each
        pairs0 = service.stats["pair_programs"]
        codes, outs = [], []
        for f in frames:
            reset_launches(kernel)
            code, body = call("/v1/stream/smoke/frame", pack_frames([f]))
            codes.append(code)
            outs.append(unpack_frames(body) if code == 200 else None)
        require_launches(kernel, "a steady stream frame", want=5)
        launches["stream_frame"] = kernel.LAUNCHES
        expect("stream codes", codes, [202, 202, 200, 200])
        expect("pair stages for 4 stream frames", service.stats["pair_programs"] - pairs0, 3)
        stream_diff = [u8_diff(a, b) for a, b in zip(outs[2], window)]
        if max(d[0] for d in stream_diff) > 1 or max(d[1] for d in stream_diff) >= 0.02:
            raise AssertionError(f"[serve] stream vs /v1/window: {stream_diff}")
        code, body = call("/v1/stream/smoke", method="DELETE")
        expect("DELETE", (code, json.loads(body)["dropped"]), (200, True))

        # the colour edge
        rgb = [yuv2rgb_matlab_u8(f) for f in frames[:3]]
        code, body = call("/v1/window?colorspace=rgb", pack_frames(rgb))
        want = [yuv2rgb_matlab_u8(o) for o in service.window(_yuv_from(rgb, "rgb"))]
        expect("rgb window", code, 200)
        if not all(np.array_equal(a, b) for a, b in zip(unpack_frames(body), want)):
            raise AssertionError("[serve] rgb window differs from yuv2rgb_matlab_u8 of the YUV one")
        log(f"[serve] /healthz, /v1/info, /metrics, 401, 413, 400 as expected; /v1/window "
            f"{launches['window']} launches, equal to FISRService.window, vs the fused step "
            f"(max, mean u8) {hand_diff}; stream 202, 202, 200, 200, 3 pairs, "
            f"{launches['stream_frame']} launches a steady frame, first window vs /v1/window "
            f"{stream_diff}; rgb window equal")

        # times: the service (host clock around calls that end in a download)
        # and the HTTP round trip (client PNG encode, post, server work, decode)
        def timed_calls(fn, reps):
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            return ts

        service.window(frames[:3])
        for f in frames[:3]:
            service.stream_frame("steady", f)
        times = {
            "window": spread_ms(timed_calls(lambda: service.window(frames[:3]), 5)),
            "stream_frame": spread_ms(timed_calls(
                lambda: service.stream_frame("steady", frames[3]), 5)),
            "http_window": spread_ms(timed_calls(
                lambda: unpack_frames(call("/v1/window", pack_frames(frames[:3]))[1]), 3)),
            "http_stream_frame": spread_ms(timed_calls(
                lambda: unpack_frames(call("/v1/stream/steady/frame", pack_frames(frames[3:]))[1]),
                3)),
        }
        service.drop_stream("steady")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for k, v in times.items():
            log(f"[serve] {k}: median {v['median_ms']:.2f} ms (min {v['min_ms']:.2f}, max "
                f"{v['max_ms']:.2f}, n {v['n']})")
        log(f"[serve] peak {peak_gib:.2f} GiB")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # tune: a short sweep into a cache at tmp, then 'tuned' resolves to its winner
    cache = autotune.TuneCache(os.path.join(tmp, "autotune.json"), device="cuda")
    cache.tune(service.fisr_params, h, w, policy=BF16, reps=3, grids=[(1, 1), (2, 2), (4, 6)])
    plan = cache.best_plan(h, w, "bfloat16")
    with open(cache.path) as f:
        (entry,) = json.load(f).values()
    table = entry["results"]
    default_path = autotune.DEFAULT_CACHE_PATH
    autotune.DEFAULT_CACHE_PATH = cache.path
    try:
        tuned = resolve_fisr_plan("tuned", h, w, BF16, device="cuda")
    finally:
        autotune.DEFAULT_CACHE_PATH = default_path
    expect("'tuned' plan", tuned, plan)
    log(f"[serve] sweep (bf16 {h}x{w}, reps 3): "
        + ", ".join(f"{tuple(r['grid'])} {1e3 * r['sec']:.2f} ms" for r in table)
        + f"; 'tuned' resolves to {tuned}")
    return {"launches": launches, "times": times, "peak_gib": peak_gib, "sweep": table}


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


def have_module(name: str) -> bool:
    try:
        __import__(name)
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
    artifacts = have_module("h5py")
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
    if have_module("h5py"):
        flow_path, warp_path = os.path.join(tmp, "eval.flo"), os.path.join(tmp, "eval_warp.mat")
        flo.write_flo_5dim(flow, flow_path)
        matio.write_warp_mat(warp, warp_path)
        res = evaluate.evaluate_test_set(runner, lr_dir, gt_dir, flow_path, warp_path, **kw)
    else:
        res = evaluate.evaluate_scenes(runner, lr_dir, gt_dir, flow, warp / 255.0, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    vals = (res.psnr_vfi_sr, res.psnr_sr, res.ssim_vfi_sr, res.ssim_sr, res.sec_per_frame)
    if res.n_frames != 7 or not np.isfinite(vals).all() or not (
            -1 <= res.ssim_vfi_sr <= 1 and -1 <= res.ssim_sr <= 1):
        raise AssertionError(f"eval: {res}")
    log(f"[eval] TiledRunner (2, 2) exact, bf16, ssim_impl=gaussian: {res}")
    if len(os.listdir(kw["out_dir"])) != 7:
        raise AssertionError(f"eval wrote {os.listdir(kw['out_dir'])}")
    log(f"[eval] through {'evaluate_test_set (.flo/.mat files)' if have_module("h5py") else 'evaluate_scenes (no h5py here)'}: "
        f"one pass in {seconds:.2f} s, peak {peak_gib:.2f} GiB")
    sec_per_frame = res.sec_per_frame

    class TruthRunner:
        """Returns the ground truth for each window: scoring must then be perfect."""
        grid, sf, device = (2, 2), 2, dev

        def __call__(self, inp):
            hh = 2 * inp.shape[1]
            if not inp.any():  # the warm-up call
                return np.zeros((3, hh, 2 * inp.shape[2], 9), np.float32)
            return np.stack([np.concatenate(list(gt[2 * i:2 * i + 3, :hh]), 2)
                             for i in range(3)]).astype(np.float32) / 255.0

    # both SSIM scorers (the card's Gaussian one, the host's PIL one) on it
    for impl in ("gaussian", "pil"):
        res = evaluate.evaluate_scenes(TruthRunner(), lr_dir, gt_dir, flow, warp / 255.0,
                                       input_size=(h0, w0), verbose=False, ssim_impl=impl)
        if not (res.psnr_vfi_sr > 120 and res.psnr_sr > 120 and abs(res.ssim_vfi_sr - 1) < 1e-6
                and abs(res.ssim_sr - 1) < 1e-6 and res.n_frames == 7):
            raise AssertionError(f"ground truth scored against itself ({impl}): {res}")
        log(f"[eval] ground truth against itself, ssim_impl={impl}: PSNR {res.psnr_vfi_sr:.1f} / "
            f"{res.psnr_sr:.1f} dB, SSIM {res.ssim_vfi_sr:.7f} / {res.ssim_sr:.7f}")
    return sec_per_frame, peak_gib


def wall_ms(fn, reps=3, warmup=1):
    """Host clock around `reps` calls that end in a synchronise: a training
    step's time as its caller sees it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def device_busy(fn, reps=2):
    """(ms the card is busy, CUDA kernels and copies) a call of `fn`, from
    torch.profiler: beside the call's wall time they say how far the host's
    launches hold the card back. Only the card's activity is traced."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_card = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        raise AssertionError("torch.profiler recorded no device activity")
    return sum(ev.device_time for ev in on_card) / 1e3 / reps, len(on_card) / reps


def moved(before, model):
    return any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


def snapshot(model):
    return [p.detach().clone() for p in model.parameters()]


def phase_train(tmp):
    from fisr_tpu_torch.convert import params
    from fisr_tpu_torch.data.synth import synthetic_store
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.ops.conv import BF16, F32
    from fisr_tpu_torch.train import trainer
    from fisr_tpu_torch.train.checkpoint import CheckpointManager
    from fisr_tpu_torch.train.loop import fit

    steps, batch_size = 6, 8
    store = synthetic_store(n_samples=steps * batch_size + 2, h=TRAIN_PATCH, w=TRAIN_PATCH,
                            seed=0, val_size=2)
    ckpt, logs = os.path.join(tmp, "train_ckpt"), os.path.join(tmp, "train_log")
    kw = dict(ckpt_dir=ckpt, log_dir=logs, batch_size=batch_size, val_batch_size=2,
              freq_display=2, policy=BF16, device="cuda")
    reset_launches(kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fit(store, epochs=1, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_fit = torch.cuda.max_memory_allocated() / 2**30
    require_launches(kernel, "fit (FISRnet has no kernel)", want=0)
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        rec = json.loads(f.read().splitlines()[-1])
    if state.step != steps or rec["step"] != steps or not np.isfinite(list(rec.values())).all():
        raise AssertionError(f"fit: step {state.step}, epoch record {rec}")
    mgr = CheckpointManager(ckpt)
    if mgr.latest_step() != steps:
        raise AssertionError(f"fit left checkpoint step {mgr.latest_step()}, want {steps}")
    log(f"[train] fit: {steps} steps of batch {batch_size} ({TRAIN_PATCH}x{TRAIN_PATCH} patches, "
        f"bf16) + validation + checkpoint in {seconds:.2f} s, peak {peak_fit:.2f} GiB; epoch means "
        f"total_loss {rec['total_loss']:.6f}, train_PSNR {rec['train_PSNR']:.3f}, "
        f"val_PSNR {rec['val_PSNR']:.3f}")
    # a second call resumes: nothing is left of epoch 0, so it returns what it restored
    resumed = fit(store, epochs=1, **kw)
    same = all(torch.equal(a, b) for a, b in zip(resumed.model.parameters(),
                                                  state.model.parameters()))
    moments = all(torch.equal(resumed.optimizer.state[a][f], state.optimizer.state[b][f])
                  for a, b in zip(resumed.model.parameters(), state.model.parameters())
                  for f in ("mu", "nu"))
    if not (same and moments and resumed.step == steps and resumed.optimizer.count == steps):
        raise AssertionError(f"resumed state differs from the saved one: step {resumed.step}, "
                             f"parameters equal {same}, moments equal {moments}")
    log(f"[train] resume: step {resumed.step}, parameters and Adam moments bit-equal to the "
        f"saved ones")
    del state, resumed

    # the first step in f32 on the card against the CPU, on one set of weights
    # (the first two samples of the first batch: the CPU's side at full width
    # takes seconds a sample)
    batch = next(store.batches(batch_size, epoch_seed=0))
    first = {k: v[:2] for k, v in batch.items()}
    terms = {}
    for dev in ("cuda", "cpu"):
        model = params.deterministic_fisrnet(device=dev)
        st = trainer.TrainState(model, trainer.tf_adam(1e-4)(model.parameters()))
        t0 = time.perf_counter()
        st, m = trainer.make_train_step(policy=F32)(st, first)
        terms[dev] = {k: float(v) for k, v in m.items()}
        log(f"[train] first f32 step on {dev}: {time.perf_counter() - t0:.2f} s, "
            f"total_loss {terms[dev]['total_loss']:.6f}")
        if dev == "cuda":
            card = st
    worst = max(abs(terms["cuda"][k] - terms["cpu"][k]) / abs(terms["cpu"][k]) for k in terms["cpu"])
    if len(terms["cpu"]) != 11 or not worst <= TRAIN_TOL:
        raise AssertionError(f"first step, card vs CPU: {terms} (worst {worst}, bound {TRAIN_TOL})")
    log(f"[train] first step's ten loss terms and train_PSNR (batch 2), card (f32, TF32 off) vs CPU: worst "
        f"relative difference {worst:.3g} (bound {TRAIN_TOL})")

    # repeated steps on that batch lower the loss; then ms per step in both dtypes
    dev_batch = trainer.batch_to_device(batch, "cuda")
    step32 = trainer.make_train_step(policy=F32)
    totals = []
    for _ in range(6):
        card, m = step32(card, dev_batch)
        totals.append(float(m["total_loss"]))
    if not (np.isfinite(totals).all() and totals[-1] < totals[0]):
        raise AssertionError(f"total_loss did not fall on one batch: {totals}")
    out = {}
    for name, policy in (("f32", F32), ("bf16", BF16)):
        step = trainer.make_train_step(policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(lambda: step(card, dev_batch))
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy, kernels = device_busy(lambda: step(card, dev_batch))
        out[name] = {"ms": ms, "peak_gib": peak, "busy_ms": busy, "kernels": kernels}
    from fisr_tpu_torch.train.loop import read_metrics

    _, m = step32(card, dev_batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    read_metrics(m)
    readback_ms = 1e3 * (time.perf_counter() - t0)
    log(f"[train] total_loss over 6 steps on one batch: {totals[0]:.6f} -> {totals[-1]:.6f}; "
        f"batch {batch_size}: "
        + "; ".join(f"{n} {o['ms']:.2f} ms a step ({1e3 * batch_size / o['ms']:.1f} samples/s, peak "
                    f"{o['peak_gib']:.2f} GiB, card busy {o['busy_ms']:.2f} ms in "
                    f"{o['kernels']:.0f} kernels)" for n, o in out.items())
        + f"; one stacked read-back of the 11 metrics {readback_ms:.3f} ms")


def cv_backward(kernel, shapes, dtype, g):
    """The cost volume's backward alone at each of `shapes`, on random
    tensors: the backward kernel (what _CostVolume.backward launches) and the
    plain version's autograd with the plain forward recomputed inside it (what
    _CostVolume.backward ran before the kernel: the baseline).
    For each: ms as its caller waits for one backward at every shape (CUDA
    events around calls through autograd: the host's launches are in it), and
    the card's busy ms and CUDA kernels over the same (torch.profiler); for
    the kernel also `graph_ms`, the card's time from a CUDA-graph replay of
    the wrapper's launches."""
    from fisr_tpu_torch.ops.cost_volume import cost_volume as plain

    def plain_backward(a, b, grad):
        a, b = a.detach().requires_grad_(True), b.detach().requires_grad_(True)
        return torch.autograd.grad(plain(a, b, D), (a, b), grad)

    out = {}
    for impl in ("kernel", "plain"):
        calls, graphs, wall = [], [], 0.0
        for shape in shapes:
            a = torch.randn(shape, device="cuda", generator=g).to(dtype).requires_grad_(True)
            b = torch.randn(shape, device="cuda", generator=g).to(dtype).requires_grad_(True)
            grad = torch.randn(tuple(shape[:3]) + ((2 * D + 1) ** 2,), device="cuda",
                               generator=g).to(dtype)
            if impl == "kernel":
                cv = kernel.cost_volume_cuda(a, b, D)
                calls.append(functools.partial(torch.autograd.grad, cv, (a, b), grad,
                                               retain_graph=True))
            else:
                calls.append(functools.partial(plain_backward, a, b, grad))
            wall += time_ms(calls[-1], reps=5, warmup=1)
            graphs.append((a.detach(), b.detach(), grad))
        busy, kernels = device_busy(lambda: [call() for call in calls])
        out[impl] = {"ms": wall, "busy_ms": busy, "kernels": kernels}
        if impl == "kernel":
            out[impl]["graph_ms"] = sum(
                graph_time_ms(lambda: kernel.cost_volume_backward_cuda(a, b, grad, D))
                for a, b, grad in graphs)
    return out


def phase_pwc_train(tmp):
    from fisr_tpu_torch.convert import params
    from fisr_tpu_torch.data.flow_dataset import FlowDataset
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.models import pwcnet
    from fisr_tpu_torch.ops.conv import BF16, F32
    from fisr_tpu_torch.train import pwc_trainer, schedule, trainer
    from fisr_tpu_torch.train.checkpoint import CheckpointManager
    from fisr_tpu_torch.train.pwc_loss import pwcnet_loss

    h, w = PWC_CROP
    ds = FlowDataset.synthetic_textured(n=10, h=h, w=w, seed=0, val_split=0.2)
    batch = trainer.batch_to_device(next(ds.batches(8, train=True, epoch_seed=0)), "cuda")
    val = next(ds.batches(8, train=False))

    # f32: parameter gradients through the kernel against those through the plain version
    model = params.deterministic_pwcnet(device="cuda")
    grads = {}
    for impl in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        reset_launches(kernel)
        _, pyr = pwcnet.apply(model, batch["x"][:, 0], batch["x"][:, 1],
                              pwcnet.PWCNetConfig(cost_volume_impl=impl), F32)
        pwcnet_loss(batch["y"], pyr, list(model.parameters())).backward()
        torch.cuda.synchronize()
        require_launches(kernel, f"PWC-Net forward + backward ({impl})",
                         want=5 if impl == "kernel" else 0, variant="fma_f32")
        require_backward(kernel, f"PWC-Net forward + backward ({impl})",
                         want=5 if impl == "kernel" else 0, variant="bwd_f32")
        grads[impl] = [p.grad.clone() for p in model.parameters()]
    top = max(float(g.abs().max()) for g in grads["plain"])
    worst = max(float((a - b).abs().max()) for a, b in zip(grads["kernel"], grads["plain"]))
    if not worst <= GRAD_TOL * top:
        raise AssertionError(f"parameter gradients, kernel vs plain: {worst} against largest {top}")
    log(f"[pwc_train] f32 parameter gradients, the kernels (forward and backward) vs the plain "
        f"version and its autograd: max |diff| "
        f"{worst:.3g} = {worst / top:.3g} of the largest gradient (bound {GRAD_TOL})")

    level_shapes = [(8, h >> lvl, w >> lvl, c) for lvl, c in LEVEL_CHANNELS.items()]
    errs, bwd_errs, steps = {}, {}, {}
    for name, policy, variant in (("f32", F32, "fma_f32"), ("bf16", BF16, "mma_bf16")):
        state = pwc_trainer.create_pwc_state(0, trainer.tf_adam(1e-4), device="cuda")
        step = pwc_trainer.make_pwc_train_step(policy=policy)
        reset_launches(kernel)
        with recorded_launches(kernel) as (seen, seen_bwd):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        require_launches(kernel, f"pwc train step ({name})", want=5, variant=variant)
        require_backward(kernel, f"pwc train step ({name})", want=5, variant=f"bwd_{name}")
        launches, bwd_launches = kernel.LAUNCHES, kernel.BACKWARD_LAUNCHES
        errs[name] = check_recorded(kernel, seen, level_shapes, f"pwc train step ({name})", seed=6)
        bwd_errs[name] = check_recorded(kernel, seen_bwd, level_shapes,
                                        f"pwc train step ({name})", seed=9, backward=True)
        losses = [float(m["loss"])]
        for _ in range(5):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"pwc loss did not fall on one batch ({name}): {losses}")
        epe = float(pwc_trainer.make_pwc_eval_step(policy=policy)(state.model, val)["epe"])
        if not np.isfinite(epe):
            raise AssertionError(f"eval EPE ({name}): {epe}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(lambda: step(state, batch))
        peak = torch.cuda.max_memory_allocated() / 2**30

        # of a step, the time inside the cost volume's backward, by level
        events, orig = [], kernel._CostVolume.backward

        def timed(ctx, g):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            res = orig(ctx, g)
            stop.record()
            events.append((ctx.saved_tensors[0].shape[1], start, stop))
            return res

        kernel._CostVolume.backward = staticmethod(timed)
        try:
            for _ in range(3):
                state, m = step(state, batch)
            torch.cuda.synchronize()
        finally:
            kernel._CostVolume.backward = staticmethod(orig)
        by_level = {}
        for rows, start, stop in events:
            lvl = int(round(np.log2(h / rows)))
            by_level[lvl] = by_level.get(lvl, 0.0) + start.elapsed_time(stop) / 3
        if sorted(by_level) != [2, 3, 4, 5, 6] or len(events) != 15:
            raise AssertionError(f"cost-volume backward ran at levels {sorted(by_level)}, "
                                 f"{len(events)} times in 3 steps")
        inside = sum(by_level.values())
        busy, kernels = device_busy(lambda: step(state, batch))
        steps[name] = {"ms": ms, "busy_ms": busy, "kernels": kernels, "peak_gib": peak,
                       "inside_backward_ms": inside, "launches": launches,
                       "bwd_launches": bwd_launches}
        log(f"[pwc_train] {name}: 5 {variant} and 5 bwd_{name} launches a step, the kernels "
            f"against the plain versions at their shapes {[list(s) for s in level_shapes]}: max "
            f"|diff| {errs[name]:.3g} forward, {bwd_errs[name]:.3g} backward; loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} over 6 steps on one batch; eval EPE {epe:.4f}; {ms:.2f} ms a step "
            f"(batch 8 of {h}x{w}, {8e3 / ms:.1f} samples/s), peak {peak:.2f} GiB, card busy "
            f"{busy:.2f} ms in {kernels:.0f} kernels; inside the "
            f"cost volume's backward {inside:.2f} ms a step ({100 * inside / ms:.0f} %), by level "
            + ", ".join(f"{lvl}: {by_level[lvl]:.2f}" for lvl in sorted(by_level)))

    # that backward alone at the five level shapes of this batch
    g = torch.Generator(device="cuda").manual_seed(5)
    backward = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        backward[name] = cv_backward(kernel, level_shapes, dtype, g)
        k, p = backward[name]["kernel"], backward[name]["plain"]
        log(f"[pwc_train] cost-volume backward alone, {name}, [8, {h}>>l, {w}>>l, C], five "
            f"levels: kernel graph_ms {k['graph_ms']:.4f}, card busy {k['busy_ms']:.4f} ms in "
            f"{k['kernels']:.0f} kernels, {k['ms']:.3f} ms as its caller waits; plain version's "
            f"autograd card busy {p['busy_ms']:.3f} ms in {p['kernels']:.0f} kernels, "
            f"{p['ms']:.3f} ms as its caller waits")

    # the step-driven loop and the per-sample report, as a user calls them
    ckpt, preds = os.path.join(tmp, "pwc_ckpt"), os.path.join(tmp, "pwc_preds")
    reset_launches(kernel)
    t0 = time.perf_counter()
    state = pwc_trainer.pwc_fit(ds, ckpt, steps=2, batch_size=8, val_every=2, display_every=1,
                                schedule_fn=schedule.no_decay(1e-4), policy=BF16,
                                log_dir=os.path.join(tmp, "pwc_log"), device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # 2 steps + one validation batch + the flow panel, 5 levels each
    require_launches(kernel, "pwc_fit (2 steps, 1 validation batch, 1 panel)", want=20)
    require_backward(kernel, "pwc_fit (2 steps)", want=10, variant="bwd_bf16")
    saved = CheckpointManager(ckpt, best_mode="min").restore()
    avg_epe, avg_dur, rows = pwc_trainer.pwc_eval_report(state.model, ds, batch_size=8, policy=BF16,
                                                         save_preds_dir=preds)
    if not (state.step == 2 == int(saved["step"]) and len(rows) == ds.val_size == 2
            and np.isfinite([avg_epe, avg_dur] + [r["EPE"] for r in rows]).all()
            and len(os.listdir(preds)) == 2 * ds.val_size):
        raise AssertionError(f"pwc_fit / pwc_eval_report: step {state.step}, rows {rows}, "
                             f"files {os.listdir(preds)}")
    log(f"[pwc_train] pwc_fit: 2 steps + validation + flow panel + checkpoint in {seconds:.2f} s, "
        f"20 mma_bf16 and 10 bwd_bf16 launches; pwc_eval_report: {len(rows)} rows, EPE {avg_epe:.4f}, "
        f"{1e3 * avg_dur:.2f} ms a sample")
    return {"launches": launches, "backward": backward, "errs": errs,
            "bwd_err": max(bwd_errs.values()), "steps": steps}


def phase_joint(fisr, pwc):
    from fisr_tpu_torch.data.synth import synthetic_video_windows
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.ops.conv import BF16, F32
    from fisr_tpu_torch.train import joint, trainer

    frames, target = synthetic_video_windows(2, h=TRAIN_PATCH, w=TRAIN_PATCH, seed=0)
    batch = trainer.batch_to_device({"frames": frames, "target": target}, "cuda")
    saved = [snapshot(fisr), snapshot(pwc)]

    def restore():
        with torch.no_grad():
            for model, snap in zip((fisr, pwc), saved):
                for p, s in zip(model.parameters(), snap):
                    p.copy_(s)
                model.zero_grad(set_to_none=True)

    # both flow calls of a step take 2B rows of the upscaled frame's pyramid
    side = TRAIN_PATCH * FLOW_UPSCALE
    level_shapes = 2 * [(4, side >> lvl, side >> lvl, c) for lvl, c in LEVEL_CHANNELS.items()]
    launches, max_err, bwd_launches, bwd_err = None, 0.0, {}, 0.0
    try:
        for name, train_pwc in (("both", True), ("frozen", False)):
            restore()  # each case starts from the weights this phase was given
            state = joint.create_joint_state(fisr, pwc, trainer.tf_adam(1e-4),
                                             trainer.tf_adam(1e-5) if train_pwc else None)
            step = joint.make_joint_train_step(policy=F32, upscale=FLOW_UPSCALE)
            before = [snapshot(fisr), snapshot(pwc)]
            reset_launches(kernel)
            with recorded_launches(kernel) as (seen, seen_bwd):
                state, m = step(state, batch)
            torch.cuda.synchronize()
            require_launches(kernel, f"joint step ({name})", want=10, variant="fma_f32")
            # the flow model's backward runs only when it trains
            require_backward(kernel, f"joint step ({name})", want=10 if train_pwc else 0,
                             variant="bwd_f32")
            launches, bwd_launches[name] = kernel.LAUNCHES, kernel.BACKWARD_LAUNCHES
            err = check_recorded(kernel, seen, level_shapes, f"joint step ({name})", seed=7)
            if train_pwc:
                bwd_err = max(bwd_err, check_recorded(
                    kernel, seen_bwd, level_shapes, f"joint step ({name})", seed=10, backward=True))
            if not moved(before[0], fisr) or moved(before[1], pwc) != train_pwc:
                raise AssertionError(f"joint step ({name}): FISRnet moved {moved(before[0], fisr)}, "
                                     f"PWC-Net moved {moved(before[1], pwc)}")
            losses = [float(m["joint_loss"])]
            for _ in range(5):
                state, m = step(state, batch)
                losses.append(float(m["joint_loss"]))
            if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
                raise AssertionError(f"joint_loss did not fall on one batch ({name}): {losses}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = wall_ms(lambda: step(state, batch))
            peak = torch.cuda.max_memory_allocated() / 2**30
            step16 = joint.make_joint_train_step(policy=BF16, upscale=FLOW_UPSCALE)
            reset_launches(kernel)
            with recorded_launches(kernel) as (seen, seen_bwd):
                step16(state, batch)
            torch.cuda.synchronize()
            require_launches(kernel, f"joint step ({name}, bf16)", want=10)
            require_backward(kernel, f"joint step ({name}, bf16)", want=10 if train_pwc else 0,
                             variant="bwd_bf16")
            err16 = check_recorded(kernel, seen, level_shapes, f"joint step ({name}, bf16)", seed=8)
            if train_pwc:
                bwd_err = max(bwd_err, check_recorded(
                    kernel, seen_bwd, level_shapes, f"joint step ({name}, bf16)", seed=11,
                    backward=True))
            max_err = max(max_err, err, err16)
            ms16 = wall_ms(lambda: step16(state, batch))
            busy, kernels = device_busy(lambda: step(state, batch))
            log(f"[joint] {name}: 10 cost-volume launches a step (2 flow calls x 5 levels; fma_f32 "
                f"in f32, mma_bf16 in bf16) and {bwd_launches[name]} backward launches, the "
                f"kernels against the plain versions at their shapes (backward max |diff| so far "
                f"{bwd_err:.3g}) "
                f"[4, {side}>>l, {side}>>l, C]: max |diff| {err:.3g} (f32), {err16:.3g} (bf16); B=2 windows of {TRAIN_PATCH}x{TRAIN_PATCH}, upscale "
                f"{FLOW_UPSCALE}: joint_loss {losses[0]:.6f} -> {losses[-1]:.6f} over 6 steps on one "
                f"batch, PSNR {float(m['joint_PSNR']):.3f} dB; f32 {ms:.2f} ms a step, bf16 "
                f"{ms16:.2f} ms, peak {peak:.2f} GiB, card busy {busy:.2f} ms in {kernels:.0f} "
                f"kernels (f32); PWC-Net "
                f"{'moved' if train_pwc else 'did not move'}")
            del state
    finally:
        restore()
    return launches, max_err, bwd_launches, bwd_err


def same_weights(got, want, what):
    """Every state-dict tensor of `got` bit-equal to `want`'s, or raises."""
    a, b = got.state_dict(), want.state_dict()
    if list(a) != list(b):
        raise AssertionError(f"{what}: state-dict keys differ")
    for k in a:
        if a[k].device != b[k].device or not torch.equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs from the original ({a[k].device})")


def phase_weights(fisr, pwc, tmp):
    """The full-width models as TF1 bundles, back through the CLI's TF flags
    and through convert.cli + the checkpoint route, bit for bit."""
    from fisr_tpu_torch.cli import main as cli
    from fisr_tpu_torch.convert import params, tensor_bundle, tf_import
    from fisr_tpu_torch.convert.cli import main as convert_main

    prefixes, lines = {}, []
    for what, model, export in (("fisrnet", fisr, tf_import.export_fisrnet),
                                ("pwcnet", pwc, tf_import.export_pwcnet)):
        prefix = os.path.join(tmp, "tf1", f"{what}.ckpt-122000")
        t0 = time.perf_counter()
        tensor_bundle.write_bundle(prefix, export(params.to_jax_tree(model)))
        t_write = time.perf_counter() - t0
        mb = os.path.getsize(prefix + ".data-00000-of-00001") / 1e6
        t0 = time.perf_counter()
        tensor_bundle.read_bundle(prefix)
        t_read = time.perf_counter() - t0
        prefixes[what] = prefix
        lines.append(f"{what} {mb:.1f} MB: write (with crc32c) {t_write:.2f} s, read "
                     f"{t_read:.3f} s ({mb / t_read:.0f} MB/s)")
    # the CLI's TF1 flags build both models on the card
    args = cli.parse_args(["--fisr_tf_ckpt", prefixes["fisrnet"],
                           "--pwc_tf_ckpt", prefixes["pwcnet"]])
    same_weights(cli._model(args, "cuda", "fisr"), fisr, "--fisr_tf_ckpt")
    same_weights(cli._model(args, "cuda", "pwc"), pwc, "--pwc_tf_ckpt")
    # convert.cli into checkpoints of the port, then the default restore route
    ck = os.path.join(tmp, "converted")
    convert_main(["--model", "fisrnet", "--ckpt", prefixes["fisrnet"],
                  "--out", os.path.join(ck, "FISRnet_exp1"), "--step", "122000"])
    t0 = time.perf_counter()
    convert_main(["--model", "pwcnet", "--ckpt", prefixes["pwcnet"],
                  "--out", os.path.join(ck, "pwcnet"), "--step", "595000", "--verify-crc"])
    t_verify = time.perf_counter() - t0
    args = cli.parse_args(["--checkpoint_dir", ck])
    same_weights(cli._model(args, "cuda", "fisr"), fisr, "convert.cli + checkpoint (FISRnet)")
    same_weights(cli._model(args, "cuda", "pwc"), pwc, "convert.cli + checkpoint (PWC-Net)")
    log(f"[weights] TF1 bundles: {'; '.join(lines)}; convert.cli --verify-crc of the PWC-Net "
        f"bundle {t_verify:.2f} s (read, crc32c of every tensor and block, check, save)")
    log("[weights] --fisr_tf_ckpt / --pwc_tf_ckpt and convert.cli --ckpt + the checkpoint "
        "route: every state-dict tensor on the card bit-equal to the originals")
    return os.path.join(ck, "pwcnet")


def phase_trained(fisr, folder, tmp):
    """The repo's trained PWC-Net (an orbax store, checkpoint_dir/pwcnet)
    through the CLI's default restore, then the fused main path with it
    (`trained_main_path`). Returns (the module, the path's launches), or
    (None, None) where this machine cannot read orbax."""
    from fisr_tpu_torch.cli import main as cli
    from fisr_tpu_torch.convert.orbax_read import ORBAX_ROUTE
    from fisr_tpu_torch.train.checkpoint import CheckpointManager

    if not have_module("tensorstore"):
        # the reader's refusal, on a step directory shaped like orbax's
        step = os.path.join(tmp, "orbax", "step_1")
        os.makedirs(step)
        for name in ("_METADATA", "manifest.ocdbt"):
            open(os.path.join(step, name), "w").close()
        try:
            CheckpointManager(os.path.dirname(step)).restore()
        except ImportError as e:
            if ORBAX_ROUTE not in str(e):
                raise AssertionError(f"orbax ImportError does not name {ORBAX_ROUTE}: {e}")
        else:
            raise AssertionError("an orbax step restored without tensorstore")
        log("[trained] this machine has no tensorstore: the orbax route was not exercised on the "
            "card (the CPU tests cover it); restoring an orbax step raises the ImportError that "
            "names the convert.cli --orbax route")
        return None, None
    root = os.path.dirname(os.path.abspath(__file__))
    args = cli.parse_args(["--checkpoint_dir", os.path.join(root, "checkpoint_dir")])
    pwc = cli._model(args, "cuda", "pwc")
    info = trained_main_path(fisr, pwc, folder, tmp, "checkpoint_dir/pwcnet through the CLI's "
                                                     "default restore")
    return pwc, info["launches"]


def trained_main_path(fisr, pwc, folder, tmp, source):
    """The fused main path on the frames of `folder` with a trained PWC-Net
    (15 launches, all mma_bf16), the steady window's time and spread, and an
    f32 flow of a crop on the card against the same module on the CPU.
    Returns {launches, steady (ms spread), flow_err, flow_scale}."""
    from fisr_tpu_torch.infer.video import make_fisr_window_fn, make_flow_fn, make_pair_fn
    from fisr_tpu_torch.infer.video import run_video_pipeline
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.ops.conv import BF16, F32

    h, w = WINDOW
    torch.cuda.synchronize()
    reset_launches(kernel)
    with torch.inference_mode():
        outs = run_video_pipeline(fisr, pwc, folder, out_folder=os.path.join(tmp, "trained"),
                                  policy=BF16, fused=True, flow_upscale=FLOW_UPSCALE,
                                  device="cuda", verbose=False)
    torch.cuda.synchronize()
    require_launches(kernel, "trained main path")
    launches = kernel.LAUNCHES
    if len(outs) != 6:
        raise AssertionError(f"trained pipeline wrote {len(outs)} outputs")
    pair_fn, window_fn = make_pair_fn(pwc.cfg, BF16, FLOW_UPSCALE), make_fisr_window_fn(BF16)
    frames = synthetic_frames(3, h, w)
    d = [torch.from_numpy(f[None]).to("cuda").float() for f in frames]
    seconds = []
    with torch.inference_mode():
        p12 = pair_fn(pwc, d[1], d[2])
        win = torch.stack(d, dim=1)
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p01 = pair_fn(pwc, d[0], d[1])
            pred = window_fn(fisr, win, p01, p12)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    if not (torch.isfinite(pred).all() and torch.isfinite(p01[0]).all()):
        raise AssertionError("trained main path: non-finite outputs")
    steady = spread_ms(seconds[1:])
    # an f32 flow of a 256x448 crop on the card against the same module on the CPU
    ch, cw = PWC_CROP
    crop = [torch.from_numpy(f[None, :ch, :cw]).float() for f in synthetic_frames(2, h, w, seed=3)]
    with torch.inference_mode():
        got = make_flow_fn(pwc.cfg, F32)(pwc, crop[0].cuda(), crop[1].cuda()).cpu()
        pwc_cpu = copy.deepcopy(pwc).cpu()
        want = make_flow_fn(pwc.cfg, F32)(pwc_cpu, crop[0], crop[1])
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if not err <= 1e-4 * scale:
        raise AssertionError(f"trained f32 flow card vs CPU: max |diff| {err} of max |flow| {scale}")
    log(f"[trained] {source}; fused main path {h}x{w} bf16: {len(outs)} outputs, {launches} cost-volume launches (all mma_bf16); "
        f"steady window (a pair + a window) {json.dumps(steady)}; f32 flow of a {ch}x{cw} crop, "
        f"card vs CPU: max |diff| {err} of max |flow| {scale} (bound 1e-4 of it)")
    return {"launches": launches, "steady": steady, "flow_err": err, "flow_scale": scale}


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block: the transposed
    convolutions of PWC-Net's upsampling otherwise may add in another order
    from one call to the next."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def phase_prepare(pwc, which, ckpt_dir, tmp):
    """cli/prepare's test-set flow precompute on one scene of 5 frames at the
    main path's size, f32; returns the launches at ss=1 and ss=2, the
    largest kernel-vs-plain |diff| at their shapes and the ms a pair."""
    from fisr_tpu_torch.cli import prepare
    from fisr_tpu_torch.data import flo
    from fisr_tpu_torch.data.png_io import read_png, write_png
    from fisr_tpu_torch.infer.video import make_flow_fn
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.ops.conv import F32

    h, w = WINDOW
    scene = os.path.join(tmp, "prepare_scene")
    os.makedirs(scene)
    for i, fr in enumerate(synthetic_frames(5, h, w, seed=5)):
        write_png(fr, os.path.join(scene, f"frame_{i:03d}.png"))
    launches, seen_all, walls = {}, [], {}
    for ss in (1, 2):
        out = os.path.join(tmp, f"prepare_ss{ss}.flo")
        torch.cuda.synchronize()
        reset_launches(kernel)
        t0 = time.perf_counter()
        with recorded_launches(kernel) as (seen, _), cudnn_deterministic():
            prepare.main(["flow-from-pngs", "--png_dir", scene, "--out", out,
                          "--pwc_ckpt", ckpt_dir, "--ss", str(ss)])
        torch.cuda.synchronize()
        walls[ss] = time.perf_counter() - t0
        want = 20 if ss == 1 else 10
        require_launches(kernel, f"prepare flow-from-pngs --ss {ss}", want=want, variant="fma_f32")
        launches[ss], seen_all = kernel.LAUNCHES, seen_all + seen
    hh, ww = h * FLOW_UPSCALE, w * FLOW_UPSCALE
    err = check_recorded(kernel, seen_all, [(2, hh >> lvl, ww >> lvl, c)
                                            for lvl, c in LEVEL_CHANNELS.items()] * 6,
                         "prepare", seed=9)
    seqs = np.stack([read_png(os.path.join(scene, f"frame_{i:03d}.png"))
                     for i in range(5)])[None].astype(np.float32)
    with cudnn_deterministic():
        flows = prepare.flows_for_sequences(pwc, seqs, 1)
    written = flo.read_flo_5dim(os.path.join(tmp, "prepare_ss1.flo"))
    if written.shape != (1, 8, h, w, 2) or not np.array_equal(written, flows):
        raise AssertionError(f"prepare .flo {written.shape} differs from flows_for_sequences "
                             f"{flows.shape}: max |diff| {np.abs(written - flows).max()}")
    warps = prepare.warps_for_sequences(seqs, flows, 1)
    if warps.shape != (1, 8, h, w, 3) or not np.isfinite(warps).all():
        raise AssertionError(f"prepare warps: shape {warps.shape} or non-finite values")
    flow_fn = make_flow_fn(pwc.cfg, F32)
    a, b = (torch.from_numpy(seqs[0, i:i + 1]).cuda() for i in (0, 1))
    pair_ms = time_ms(lambda: flow_fn(pwc, a, b), reps=5, warmup=1)
    log(f"[prepare] flow-from-pngs on 5 frames of {h}x{w} with the {which} PWC-Net, f32: "
        f"{launches[1]} cost-volume launches at ss=1 ({walls[1]:.2f} s, PNG decode included), "
        f"{launches[2]} at ss=2 ({walls[2]:.2f} s), all fma_f32; the kernel against the plain "
        f"version at their shapes: max |diff| {err}; .flo bit-equal to flows_for_sequences "
        f"(both under cuDNN's deterministic algorithms); warps finite; {pair_ms:.2f} ms a pair "
        "(flow, f32, cuDNN's defaults). build_corpus writes .mat (h5py) and stays on the CPU: "
        "not run here")
    return launches, err, pair_ms


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
    t_start = time.perf_counter()

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        torch.cuda.synchronize()
        log(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s "
            f"({time.perf_counter() - t_start:.1f} s since the start)")
        return out

    timed(phase_build)
    max_err, levels, bwd_err_ragged = timed(phase_kernel)
    from fisr_tpu_torch.convert import params

    # full-width deterministic weights (the TF-oracle generator), made once
    fisr = params.deterministic_fisrnet(ch=64, device="cuda")
    pwc = params.deterministic_pwcnet(device="cuda")
    timed(phase_small, fisr, pwc)
    with tempfile.TemporaryDirectory() as tmp:
        launches, folder = timed(phase_full, fisr, pwc, tmp)
        served = timed(phase_serve, tmp)
        timed(phase_tiled, fisr, pwc, synthetic_frames(4, *WINDOW))
        launches_staged = timed(phase_staged, fisr, pwc, folder, tmp)
        timed(phase_eval, fisr, tmp)
        timed(phase_train, tmp)
        pwc_train = timed(phase_pwc_train, tmp)
        converted_pwc = timed(phase_weights, fisr, pwc, tmp)
        trained_pwc, launches_trained = timed(phase_trained, fisr, folder, tmp)
        if trained_pwc is None:
            prepare_with = (pwc, "deterministic (the TF-oracle generator's, converted)",
                            converted_pwc)
        else:
            prepare_with = (trained_pwc, "trained (checkpoint_dir/pwcnet)", os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "checkpoint_dir", "pwcnet"))
        launches_prepare, err_prepare, prepare_pair_ms = timed(phase_prepare, *prepare_with, tmp)
    launches_joint, err_joint, bwd_launches_joint, bwd_err_joint = timed(phase_joint, fisr, pwc)
    launches_pwc_train, backward = pwc_train["launches"], pwc_train["backward"]
    err_pwc_train = max(pwc_train["errs"].values())
    h, w = PWC_CROP
    pwc_shapes = [(8, h >> lvl, w >> lvl, c) for lvl, c in LEVEL_CHANNELS.items()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"kernels": [{
        "name": "cost_volume", "route": "cuda", "variant": "mma_bf16",
        "source": "fisr_tpu_torch/csrc/cost_volume.cu",
        "replaces": "fisr_tpu/kernels/cost_volume_pallas.py:34",
        "launches": launches, "launches_staged": launches_staged,
        # per request of the serving phase: a /v1/window, a steady stream frame
        "launches_serve": served["launches"],
        # per training step: make_pwc_train_step, make_joint_train_step
        "launches_train": {"pwc_train_step": launches_pwc_train, "joint_step": launches_joint},
        # the fused main path on the repo's trained PWC-Net (null: no tensorstore here)
        "launches_trained": launches_trained,
        # over the inference window's level shapes, the ragged shapes and the
        # shapes that the pwc_train and joint steps launched, f32 and bf16
        "max_abs_err": max(max_err, err_pwc_train, err_joint),
        # one frame pair's five levels (levels 6..2) in bf16, the main path's dtype
        "ms": sum(r["bf16_ms"] for r in levels),
        "graph_ms": sum(r["bf16_graph_ms"] for r in levels),
        "plain_ms": sum(r["bf16_plain_ms"] for r in levels),
        "bound_ms": sum(r["bf16_bound_ms"] for r in levels),
        "bound_by": "bytes" if all(r["bf16_bound_by"] == "bytes" for r in levels) else "operations",
        "library_ms": None,
        # the backward (autograd of the plain version) at the five level
        # shapes of the pwc_train batch, [8, 256>>l, 448>>l, C]: as its caller
        # waits for it (the host's launches) and the card's busy time
        "backward_ms": backward["bf16"]["plain"]["ms"],
        "backward_f32_ms": backward["f32"]["plain"]["ms"],
        "backward_busy_ms": backward["bf16"]["plain"]["busy_ms"],
        "backward_f32_busy_ms": backward["f32"]["plain"]["busy_ms"],
    }, {
        "name": "cost_volume", "route": "cuda", "variant": "fma_f32",
        "source": "fisr_tpu_torch/csrc/cost_volume.cu",
        "replaces": "fisr_tpu/kernels/cost_volume_pallas.py:34",
        # f32 runs on the training paths (and --compute_dtype float32): a
        # make_pwc_train_step step's count, and per step of each path
        "launches": pwc_train["steps"]["f32"]["launches"],
        "launches_train": {"pwc_train_step": pwc_train["steps"]["f32"]["launches"],
                           "joint_step": launches_joint},
        # cli/prepare flow-from-pngs, one scene of 5 frames of 1024x1920
        "launches_prepare": {"ss1": launches_prepare[1], "ss2": launches_prepare[2]},
        "prepare_pair_ms": prepare_pair_ms,
        # the inference level shapes, the ragged shapes, the training and prepare shapes
        "max_abs_err": max([r["f32_err"] for r in levels] + [pwc_train["errs"]["f32"],
                                                             err_prepare]),
        # one frame pair's five levels (levels 6..2) in f32
        "ms": sum(r["f32_ms"] for r in levels),
        "graph_ms": sum(r["f32_graph_ms"] for r in levels),
        "plain_ms": sum(r["f32_plain_ms"] for r in levels),
        "bound_ms": sum(r["f32_bound_ms"] for r in levels),
        "bound_by": "bytes" if all(r["f32_bound_by"] == "bytes" for r in levels) else "operations",
        "library_ms": None,
    }, {
        "name": "cost_volume_backward", "route": "cuda", "variants": ["bwd_f32", "bwd_bf16"],
        "source": "fisr_tpu_torch/csrc/cost_volume.cu",
        # the TPU kernel's VJP (an XLA composition in the JAX package)
        "replaces": "fisr_tpu/kernels/cost_volume_pallas.py:77",
        "launches": pwc_train["steps"]["f32"]["bwd_launches"],
        "launches_train": {"pwc_train_step": pwc_train["steps"]["f32"]["bwd_launches"],
                           "joint_step": bwd_launches_joint["both"],
                           "joint_step_flow_frozen": bwd_launches_joint["frozen"]},
        # the ragged shapes and the shapes the pwc_train and joint steps launched
        "max_abs_err": max(bwd_err_ragged, pwc_train["bwd_err"], bwd_err_joint),
        # one backward at each of the five pwc_train level shapes, f32 (bf16 beside)
        "ms": backward["f32"]["kernel"]["ms"],
        "graph_ms": backward["f32"]["kernel"]["graph_ms"],
        "busy_ms": backward["f32"]["kernel"]["busy_ms"],
        "kernels": backward["f32"]["kernel"]["kernels"],
        "plain_ms": backward["f32"]["plain"]["ms"],
        "plain_busy_ms": backward["f32"]["plain"]["busy_ms"],
        "plain_kernels": backward["f32"]["plain"]["kernels"],
        "bound_ms": sum(cv_bwd_bound_ms(s, torch.float32)[0] for s in pwc_shapes),
        "bound_by": "bytes" if all(cv_bwd_bound_ms(s, torch.float32)[1] == "bytes"
                                   for s in pwc_shapes) else "operations",
        "bf16": {"ms": backward["bf16"]["kernel"]["ms"],
                 "graph_ms": backward["bf16"]["kernel"]["graph_ms"],
                 "busy_ms": backward["bf16"]["kernel"]["busy_ms"],
                 "plain_busy_ms": backward["bf16"]["plain"]["busy_ms"],
                 "bound_ms": sum(cv_bwd_bound_ms(s, torch.bfloat16)[0] for s in pwc_shapes)},
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
