#!/usr/bin/env python3
"""Drive the fisr_tpu_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. build  - nvcc builds every kernel of the fused video path from
   fisr_tpu_torch/csrc/ (one nvcc per source, all started together); ptxas
   must report no spills for any of its kernels (bf16 mma.sync, f32 FMA,
   backward).
   native - the host runtime (fisr_tpu_torch/native): g++ builds
   fisr_tpu_torch/csrc/native.cc and zstd.cc; every function against its
   plain version (numpy, the stdlib PNG codec of data/png_io, the crc loop of
   convert/tensor_bundle) at 1024x1920 and 2048x3840 (colour, PNG encode to
   bytes on all threads and on one, the same bytes and png_io's pixels, and
   to a file, PNG decode of filter-0 and Paeth files from bytes
   and from a file, crc32c, the row gather, the (2, 2) halo patches; a
   6-frame batch decode) and the three colour conversions over all 2^24 u8
   triples; each timed beside its plain version, with the host's cores; the
   zstd decoder (no plain version) on checkpoint_dir/pwcnet's largest chunk
   on one thread and on all 182 chunks in one batch: MB/s, decoded sizes.
2. kernel - the cost-volume kernels (bf16: mma.sync, f32: FMA) against the
   plain PyTorch version on the card at the five PWC-Net level shapes of a
   1024x1920 window (B=2, d=4), at ragged shapes (d=2 and 4, odd W and H,
   C=3, 20, 196), and the gradient; the backward kernels (bwd_f32, bwd_bf16)
   against the plain backward (ops/cost_volume.cost_volume_backward) at the
   ragged shapes (and d=2 at W=19, C=40) and at the level shapes of the
   pwc_train and joint steps,
   f32 and bf16, each launched twice with the same bits. At the level shapes
   the forward kernel is timed
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
   again warm, the warm call's host stages a window (decode, upload, card
   wait, colour, encode, file write; scripts/time_torch_pipeline.instrumented);
   then per-pair and per-window times, peak memory and a pair's peak.
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
   fastest), and the time of the weight fold of up_conv2x, anew and kept. In
   f32 at 128x128 (TF32 off): tiled_apply against TiledRunner(mode='padded'),
   within 1e-5; at 160x160 the stale-halo shrink against the full ring,
   within 1e-6.
6. staged - run_video_pipeline(fused=False, grid=(2, 2)) on the same frames:
   6 outputs, 15 more cost-volume launches (all bf16), frames compared with
   the fused run's; the .flo and .mat artifacts written and read back
   (data/flo, data/matio on the port's own HDF5 codec, data/hdf5).
7. eval   - the reference's test setting: one synthetic scene of 5 LR frames
   1080x1920 and 7 GT frames, its .flo and warp .mat (8x1080x1920x3 f32,
   199 MB) written by the port's writers (matio's write and read MB/s), through
   evaluate_test_set with TiledRunner(grid=(2, 2), boundary=32)
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
   on one batch must lower total_loss. Prints ms per step in f32 (TF32 off,
   as the F32 policy runs it, and once with PyTorch's TF32 convolutions for
   the record) and bf16, samples/s and peak memory.
9. pwc_train - train/pwc_trainer.make_pwc_train_step at full width (PWC-Net
   lg-6-2) on FlowDataset.synthetic_textured, batch 8 of 256x448, multiscale
   loss, the graphed step as pwc_fit runs it: its first 3 calls (two eager,
   then the capture) make 15 cost-volume launches, fma_f32 under F32 and
   mma_bf16 under BF16, and 15 backward launches (bwd_f32 / bwd_bf16); each
   kernel against its plain version at exactly the shapes and dtypes those
   launches had ([8, 256>>l, 448>>l, C], down to 4x7); 6 graphed steps
   across a halving of the rate bit-equal to 6 eager ones in losses,
   parameters and moments under deterministic cuDNN; 5 cost_volume_kernel
   and 5 cost_volume_bwd kernels a replayed step in torch.profiler's trace;
   in f32 the parameter gradients
   through the kernels against those through the plain version and its
   autograd (1e-5 of the largest gradient); the loss must fall over repeated
   steps on one batch; make_pwc_eval_step must give a finite EPE. Prints ms
   per replayed step (f32 also with PyTorch's TF32 convolutions, for the
   record) beside the eager step's, the card's busy time and kernels of a
   replayed step, the time inside an eager step's cost-volume backward per
   level, and times
   the backward alone at the five level shapes: the kernel's graph_ms (by
   level, beside each level's byte bound), card busy time and its caller's
   wait, against the card busy
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
   corpus - the .mat workflows, each through its CLI's main(argv) on cuda:
   cli/build_corpus on 17 synthetic YUV frames of 1080x1920 (48 samples of
   96x96) with the converted full-width PWC-Net, f32: exactly 1440 fma_f32
   launches (6 flow calls a sample x 5 levels); cli/prepare flow-from-mat
   --ss 1 on its LR .mat (960 launches) and warp-from-mat (0), both outputs
   equal to build_corpus's; the kernel against the plain version at their
   shapes; matio's write and read MB/s on the HR .mat; TrainStore.from_files'
   seconds; ms a bf16 train step fed from the file-backed store and from
   data/synth's in-memory one; cli.main --phase train on the corpus (FISRnet
   ch=64, bf16, batch 8, --val_data_size 16, 1 epoch = 4 steps, checkpoint)
   and its test phase on the eval phase's test set, then --phase test from
   the checkpoint: the same PSNR and SSIM.
12. trained - the repo's trained PWC-Net (checkpoint_dir/pwcnet, an orbax
   store) read without tensorstore or a zstd library (convert/ocdbt, the
   host runtime's zstd decoder): the read's time and MB/s (host clock,
   median of 3, page cache warm), the tree's SHA-256 against
   TRAINED_PWC_SHA256 (pinned by tests/test_torch_orbax.py against
   tensorstore's read); the CLI's default restore onto the card, bit-equal
   to the module built from that tree; the fused main path on it at
   1024x1920 bf16 (15 launches, all mma_bf16), the steady window's time and
   spread, and an f32 flow of a 256x448 crop on the card against the same
   module on the CPU (1e-4 of max |flow|).
13. prepare - cli/prepare flow-from-pngs on one scene of 5 synthetic
   1024x1920 PNG frames, f32, with the trained PWC-Net (--pwc_ckpt
   checkpoint_dir/pwcnet): exactly 20 launches at ss=1 (4
   pairs x 5 levels) and 10 at ss=2, all fma_f32, the kernel against the
   plain version at their shapes; ss=1 once more with PyTorch's TF32
   defaults around the call, bit-equal to the first (the entry point sets
   exact f32 and cuDNN's deterministic algorithms itself); the .flo
   bit-equal to flows_for_sequences under the same policy,
   warps_for_sequences finite; ms a pair with cuDNN's default algorithms
   and with its deterministic ones.
14. multi - the multi-device layer (core/mesh, infer/serving,
   infer/sharded, the data-parallel steps, MultiChipService) on an NCCL
   group of world size 1 started in this process on a file store (the
   records hold one card: no scaling is measured), destroyed at the end of
   the phase: make_frame_parallel_stream_step(ragged=True) over 5 windows
   (7 frames of 1024x1920, bf16) in rounds of 2 (2, 2, then 1 valid of 2),
   the carry threaded from make_pair_fn: its frames within MULTI_MAX_U8 /
   MULTI_MEAN_U8 of the single-card pair-cached loop, exactly 5 + 3 x 5 =
   20 mma_bf16 launches (one PWC-Net call a round batches both directions
   of its pairs; the padded window is computed too), the kernel against its
   plain version at those shapes, ms a round and a valid window;
   make_frame_parallel_video_step on 2 windows equal to the fused step, 10
   launches; make_sharded_runner on a 1-wide spatial axis equal to the
   (1, 1) padded tiling of the frame zero-padded by the halo, its ms;
   make_pwc_train_step(mesh=) at 256x448, batch 8, f32, bit-equal to the
   step without a mesh (5 fma_f32 + 5 bwd_f32 launches), ms a step with and
   without the mesh; fit(mesh=) for 2 bf16 steps with a checkpoint and a
   resume; a MultiChipService over cuda:0 twice ('auto' grid, warmed up)
   behind the HTTP server: one /v1/window (10 launches, equal to
   FISRService.window), two 4-frame streams pinned to different services
   (5 launches a steady frame, within 1 u8 count of a single service's
   stream), /v1/info chips 2.

Prints the card's name and power limit, a {"kernels": [...]} line (the
bf16 and f32 forward kernels and the backward kernel; the bf16 entry's
`launches_serve` counts a /v1/window and a steady stream frame,
`launches_trained` the trained phase's run, `launches_multi` the
multi phase's stream round, video step, window and stream frame; the f32
entry's `launches_prepare` the prepare phase's runs, `launches_corpus` the
corpus phase's; `pwc_train_step_dp` in
`launches_train` the data-parallel step's), and as its
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
TILED_TOL = 1e-5   # device tiling vs host padded tiling (f32)
TRAIN_TOL = 1e-4   # first train step's loss terms, card (f32, TF32 off) vs CPU, relative
GRAD_TOL = 1e-5    # PWC-Net parameter gradients, kernel vs plain forward, of the largest gradient
TRAIN_PATCH = 96   # the reference's training patches
PWC_CROP = (256, 448)  # upstream tfoptflow's training crop
SHRINK_TOL = 1e-6  # stale-halo shrink vs the full ring (f32): equal unless cuDNN changes algorithm
# convert/orbax_read.tree_digest of checkpoint_dir/pwcnet/step_14000, pinned by
# tests/test_torch_orbax.py against tensorstore's read of the same store
TRAINED_PWC_SHA256 = "9e18a0b4d1fe2298769497502125336b1dfc0df871809ce8d380e6b7f04d597f"
# staged (exact (2, 2) tiling) vs fused (full frame) output frames, bf16, in u8
# counts: the halo truncates the receptive field and another conv extent may
# take another bf16 summation order
STAGED_MAX_U8, STAGED_MEAN_U8 = 4, 0.03
# the cost volume's level shapes in a pwc_train step (batch 8 of PWC_CROP) and
# in a joint step (both flow calls: 2 x B=2 rows of the x2 upscaled 96x96 patch)
PWC_TRAIN_SHAPES = [(8, PWC_CROP[0] >> lvl, PWC_CROP[1] >> lvl, c)
                    for lvl, c in LEVEL_CHANNELS.items()]
JOINT_SHAPES = [(4, (TRAIN_PATCH * FLOW_UPSCALE) >> lvl, (TRAIN_PATCH * FLOW_UPSCALE) >> lvl, c)
                for lvl, c in LEVEL_CHANNELS.items()]


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
    raises. f32 within 1e-5, bf16 within `bf16_ok`; a second launch must give
    the same bits."""
    from fisr_tpu_torch.ops.cost_volume import cost_volume_backward

    a = torch.randn(shape, device="cuda", generator=g).to(dtype)
    b = torch.randn(shape, device="cuda", generator=g).to(dtype)
    grad = torch.randn(tuple(shape[:3]) + ((2 * d + 1) ** 2,), device="cuda",
                       generator=g).to(dtype)
    got = kernel.cost_volume_backward_cuda(a, b, grad, d)
    again = kernel.cost_volume_backward_cuda(a, b, grad, d)
    want = cost_volume_backward(a, b, grad, d)
    err = 0.0
    for x, y, z in zip(got, want, again):
        if not torch.equal(x, z):
            raise AssertionError(f"cost-volume backward {tuple(shape)} d={d} {dtype}: two "
                                 "launches differ")
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


def host_ms(fn, reps):
    """(fn's result, median host ms of `reps` calls)."""
    out, ms = None, []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, float(np.median(ms))


def phase_native(tmp):
    """The host runtime (fisr_tpu_torch/native): built with g++ here, then
    every function against its plain version at the main path's frame sizes,
    colour also over all 2^24 u8 triples; each timed beside its plain version
    (host clock, median of 3; the plain version once)."""
    import zlib

    from fisr_tpu_torch import native
    from fisr_tpu_torch.convert.tensor_bundle import _crc32c
    from fisr_tpu_torch.data import png_io
    from fisr_tpu_torch.native import build as nbuild
    from scripts.time_png_decode import filtered_png
    from scripts.time_torch_pipeline import host_cores

    t0 = time.perf_counter()
    lib = nbuild.build()
    native.available()
    log(f"[native] g++ built {os.path.basename(lib)} in {time.perf_counter() - t0:.2f} s; zlib "
        f"{native.zlib_version()} (Python's {zlib.ZLIB_RUNTIME_VERSION}); {host_cores()} host "
        f"cores; {os.cpu_count()} CPUs")
    plain = native.plain_versions()
    rows = []

    def check(name, size, run_native, run_plain, same=np.array_equal):
        got, native_ms = host_ms(run_native, 3)
        want, plain_ms = host_ms(run_plain, 1)
        if not same(got, want):
            raise AssertionError(f"native {name} at {size} differs from its plain version")
        rows.append({"name": name, "size": size, "ms": native_ms, "plain_ms": plain_ms})
        log(f"[native] {name} {size}: {native_ms:.2f} ms, plain version {plain_ms:.2f} ms "
            f"({plain_ms / native_ms:.1f}x), equal")

    def same_pixels(a, b):
        return np.array_equal(png_io.decode_png(a), png_io.decode_png(b))

    a = np.arange(1 << 24, dtype=np.uint32)
    triples = np.stack([(a >> 16) & 255, (a >> 8) & 255, a & 255], -1).astype(np.uint8)
    for name in ("yuv2rgb_matlab_u8", "rgb2yuv_matlab_u8", "yuv2rgb_ops_u8"):
        check(name, "all 2^24 triples", lambda: getattr(native, name)(triples),
              lambda: plain[name](triples))
    del a, triples
    for h, w in (WINDOW, (2 * WINDOW[0], 2 * WINDOW[1])):
        size = f"{h}x{w}"
        frame = synthetic_frames(1, h, w, seed=h)[0]
        for name in ("yuv2rgb_matlab_u8", "rgb2yuv_matlab_u8", "yuv2rgb_ops_u8"):
            check(name, size, lambda: getattr(native, name)(frame), lambda: plain[name](frame))
        check("encode_png_bytes", size, lambda: native.encode_png_bytes(frame),
              lambda: png_io.encode_png(frame), same_pixels)
        check("encode_png_bytes threads=1", size, lambda: native.encode_png_bytes(frame, 1),
              lambda: png_io.encode_png(frame), same_pixels)
        if native.encode_png_bytes(frame, 1) != native.encode_png_bytes(frame):
            raise AssertionError(f"native encode_png_bytes at {size}: other bytes on one thread")
        paths = [os.path.join(tmp, f"native_{size}_{k}.png") for k in range(2)]
        check("encode_png (file)", size, lambda: native.encode_png(frame, paths[0]) or paths[0],
              lambda: png_io.write_png(frame, paths[1]) or paths[1],
              lambda a, b: np.array_equal(png_io.read_png(a), png_io.read_png(b)))
        path = paths[0]
        for kind, data in (("filter 0", png_io.encode_png(frame)),
                           ("Paeth", filtered_png(frame, [4] * h))):
            check(f"decode_png_bytes {kind}", size, lambda: native.decode_png_bytes(data),
                  lambda: png_io.decode_png(data))
            with open(path, "wb") as f:
                f.write(data)
            check(f"decode_png {kind} (file)", size, lambda: native.decode_png(path),
                  lambda: png_io.read_png(path))
        check("crc32c", size, lambda: native.crc32c(frame.tobytes()),
              lambda: _crc32c(frame.tobytes()))
        stack = np.stack([frame.astype(np.float32)] * 6)
        idx = np.array([5, 3, 1, 0, 2, 4])
        check("gather_rows f32 [6, h, w, 3]", size, lambda: native.gather_rows(stack, idx),
              lambda: plain["gather_rows"](stack, idx))
        del stack
        # the (2, 2) halo tiling of the window input: 29 channels at the
        # window's size, 3 at the output's
        src = np.ascontiguousarray(
            np.repeat(frame.astype(np.float32), 29 if h == WINDOW[0] else 1, axis=2)[..., :29])
        rects = [(y, x) for y in (0, h // 2 - 32) for x in (0, w // 2 - 32)]
        check(f"extract_patches [{h}, {w}, {src.shape[2]}]", size,
              lambda: native.extract_patches(src, rects, h // 2 + 32, w // 2 + 32),
              lambda: plain["extract_patches"](src, rects, h // 2 + 32, w // 2 + 32))
        del src
    paths = []
    for i, fr in enumerate(synthetic_frames(6, *WINDOW)):
        paths.append(os.path.join(tmp, f"native_in_{i}.png"))
        png_io.write_png(fr, paths[-1])
    check("decode_png_batch 6 frames", f"{WINDOW[0]}x{WINDOW[1]}",
          lambda: native.decode_png_batch(paths), lambda: plain["decode_png_batch"](paths))
    # a flow training sample at pwc_fit's shapes: a 256x448 crop of a 384x512
    # pair, without augmentation and under plans that take every branch
    from fisr_tpu_torch.data.augment import AugmentPlan

    rng = np.random.default_rng(5)
    pair = rng.integers(0, 256, (2, 384, 512, 3), dtype=np.uint8)
    flow = rng.normal(0, 4, (384, 512, 2)).astype(np.float32)
    for plan in (None, AugmentPlan(True, True, (-12, 9), 1.04),
                 AugmentPlan(False, True, (5, 0), 0.96)):
        outs = [(np.empty((2, 256, 448, 3), np.float32), np.empty((256, 448, 2), np.float32))
                for _ in range(2)]
        check(f"flow_sample {plan}", "256x448 of 384x512",
              lambda: native.flow_sample(pair, flow, (61, 30), (256, 448), plan, *outs[0])
              or outs[0],
              lambda: plain["flow_sample"](pair, flow, (61, 30), (256, 448), plan, *outs[1])
              or outs[1],
              lambda a, b: all(np.array_equal(u, v) for u, v in zip(a, b)))
    # the zstd decoder on the trained PWC-Net's chunks (an orbax store): no
    # plain version; phase_trained holds the whole read against a pinned digest
    from fisr_tpu_torch.convert.ocdbt import OcdbtStore

    store = OcdbtStore(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "checkpoint_dir", "pwcnet", "step_14000"))
    chunks = {k: v for k, v in store.items() if not k.endswith("/.zarray")}
    sizes = {}
    for key in chunks:
        meta = json.loads(store.read(key.rsplit("/", 1)[0] + "/.zarray"))
        sizes[key] = int(np.prod(meta["chunks"])) * np.dtype(meta["dtype"]).itemsize
    largest = max(chunks, key=lambda k: len(chunks[k]))
    one, one_ms = host_ms(lambda: native.zstd_decompress(chunks[largest], sizes[largest]), 3)
    frames, want = list(chunks.values()), list(sizes.values())
    batch, batch_ms = host_ms(lambda: native.zstd_decompress_batch(frames, want), 3)
    if not np.array_equal(one, batch[list(chunks).index(largest)]):
        raise AssertionError("zstd_decompress and zstd_decompress_batch differ on one chunk")
    rows += [{"name": "zstd_decompress (largest chunk)", "size": f"{len(chunks[largest])} -> "
              f"{one.size} bytes", "ms": one_ms, "plain_ms": None},
             {"name": f"zstd_decompress_batch ({len(frames)} chunks)",
              "size": f"{sum(map(len, frames))} -> {sum(want)} bytes", "ms": batch_ms,
              "plain_ms": None}]
    log(f"[native] zstd_decompress on checkpoint_dir/pwcnet's largest chunk ({largest}): "
        f"{len(chunks[largest]) / 1e6:.2f} MB -> {one.size / 1e6:.2f} MB in {one_ms:.2f} ms on "
        f"one thread, {one.size / one_ms / 1e3:.0f} MB/s decoded; all {len(frames)} chunks in one "
        f"batch on the host's cores: {sum(map(len, frames)) / 1e6:.2f} MB -> "
        f"{sum(want) / 1e6:.2f} MB in {batch_ms:.2f} ms, {sum(want) / batch_ms / 1e3:.0f} MB/s "
        "decoded (no plain version: [trained] checks the read's SHA-256)")
    log("[native] " + json.dumps({"host_cores": host_cores(), "rows": rows}))
    return rows


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
    # the backward kernel against the plain backward at the ragged shapes (and
    # d = 2 with W off the 8-pixel tiles and C off the 16-channel m-tiles) and
    # the level shapes of the pwc_train and joint steps
    bwd_err = 0.0
    bwd_shapes = (ragged + [((1, 5, 19, 40), 2)]
                  + [(s, D) for s in PWC_TRAIN_SHAPES + JOINT_SHAPES])
    for dtype in (torch.float32, torch.bfloat16):
        for shape, d in bwd_shapes:
            bwd_err = max(bwd_err, check_backward(kernel, shape, d, dtype, g))
    a = torch.randn((1, 8, 12, 4), device=dev, generator=g, requires_grad=True)
    b = torch.randn((1, 8, 12, 4), device=dev, generator=g, requires_grad=True)
    gk = torch.autograd.grad((kernel.cost_volume_cuda(a, b, 2) ** 2).sum(), (a, b))
    gp = torch.autograd.grad((plain(a, b, 2) ** 2).sum(), (a, b))
    for x, y in zip(gk, gp):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    log(f"[kernel] all shapes and the gradient agree; max |diff| {max_err}; the backward "
        f"kernels (bwd_f32, bwd_bf16) against the plain backward at the ragged, pwc_train and "
        f"joint shapes, each launched twice with the same bits: max |diff| {bwd_err}")
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
    from scripts.time_torch_pipeline import STAGES, host_cores, instrumented

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
    walls, stages = [], {}
    for call in ("first", "second"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kernel)
        # the second call's host stages, summed over the threads that ran them
        with instrumented(stages) if call == "second" else contextlib.nullcontext():
            t0 = time.perf_counter()
            with torch.inference_mode():
                outs = run_video_pipeline(fisr, pwc, folder,
                                          out_folder=os.path.join(tmp, "fused"), policy=BF16,
                                          fused=True, flow_upscale=FLOW_UPSCALE, device=dev,
                                          verbose=False)
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
    log(f"[full] second call's host stages, s a window (2 windows; summed over threads; "
        f"{host_cores()} host cores): " + ", ".join(f"{k} {stages.get(k, 0.0) / 2:.4f}"
                                                   for k in STAGES))

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
        # a pair's peak, the resident models and tensors included
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pair_fn(pwc, d[0], d[1])
        torch.cuda.synchronize()
        pair_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[full] bf16 {h}x{w}: per pair {pair_ms:.3f} ms (peak {pair_gib:.2f} GiB), per window "
        f"(FISRnet stage) {window_ms:.3f} ms, steady state {pair_ms + window_ms:.3f} ms per "
        "output window")
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
    from fisr_tpu_torch.ops.conv import BF16, F32, _fold_up_conv_weights

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

        # f32 at a small size: the device tiling leaves the function alone
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.rand((1, 128, 128, 29), device=dev, generator=g)
        got = tiled_apply(fisr, x, (2, 2), 32, 2, F32)
        host = TiledRunner(fisr, grid=(2, 2), boundary=32, policy=F32, mode="padded", device=dev)
        e_tiled = float(np.abs(got.cpu().numpy() - host(x.cpu().numpy())).max())
        # the stale-halo shrink against the full ring on the pixels it keeps
        x = torch.rand((1, 160, 160, 29), device=dev, generator=g)
        ring = fisrnet.apply(fisr, x, 2, F32)[2][:, 64:-64, 64:-64]
        shrunk = fisrnet.apply(fisr, x, 2, F32, final_stale_halo=32)[2][:, 16:-16, 16:-16]
        e_shrink = (ring - shrunk).abs().max().item()
    if not (e_tiled <= TILED_TOL and e_shrink <= SHRINK_TOL):
        raise AssertionError(f"f32: tiled_apply vs host padded tiling {e_tiled} (bound "
                             f"{TILED_TOL}), stale-halo shrink vs full ring {e_shrink} (bound "
                             f"{SHRINK_TOL})")
    log(f"[tiled] f32 128x128: tiled_apply vs TiledRunner(padded) {e_tiled} (bound {TILED_TOL}); "
        f"160x160: stale-halo shrink vs full ring on retained pixels {e_shrink} (bound "
        f"{SHRINK_TOL}; 0 = bit-equal)")
    return plans


def mat_rates(tag, path, write, read, key):
    """Times `write` (a data/matio writer of `path`), `read` (its reader,
    straight after the write: from the page cache) and the codec's own read
    of dataset `key` (data/hdf5, without matio's /255 and axis view); logs
    MB/s of the file's bytes."""
    from fisr_tpu_torch.data import hdf5

    t0 = time.perf_counter()
    write()
    t_write = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    read()
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    with hdf5.File(path) as f:
        f[key].read()
    t_codec = time.perf_counter() - t0
    log(f"{tag} data/matio on {os.path.basename(path)} ({mb:.1f} MB): write {t_write:.3f} s "
        f"({mb / t_write:.0f} MB/s), read {t_read:.3f} s ({mb / t_read:.0f} MB/s), "
        f"data/hdf5's read alone {t_codec:.3f} s ({mb / t_codec:.0f} MB/s)")


def phase_staged(fisr, pwc, folder, tmp):
    from fisr_tpu_torch.data import flo, matio
    from fisr_tpu_torch.data.png_io import read_png
    from fisr_tpu_torch.infer.video import run_video_pipeline
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.ops.conv import BF16

    h, w = WINDOW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernel)
    t0 = time.perf_counter()
    with torch.inference_mode():
        outs = run_video_pipeline(fisr, pwc, folder, out_folder=os.path.join(tmp, "staged"),
                                  grid=(2, 2), boundary=32, policy=BF16,
                                  write_artifacts=True, fused=False,
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
        f"{seconds:.2f} s (the .flo/.mat artifacts written), peak {peak_gib:.2f} GiB; YUV frames vs "
        f"the fused run's: max {worst} u8 counts, worst frame mean {max(means):.4f} "
        f"(bounds {STAGED_MAX_U8}, {STAGED_MEAN_U8})")
    flows = flo.read_flo_5dim(os.path.join(folder, "scene1_test_ss1_fr4.flo"))
    warps = matio.read_warp_mat(os.path.join(folder, "scene1_ss1_fr4_warp.mat"))
    if flows.shape != (3, 2, h, w, 2) or warps.shape != (3, 2, h, w, 3) or not (
            np.isfinite(flows).all() and 0.0 <= warps.min() and warps.max() <= 1.0):
        raise AssertionError(f"artifacts: flows {flows.shape}, warps {warps.shape}, warp range "
                             f"[{warps.min()}, {warps.max()}]")
    log(f"[staged] artifacts read back through data/flo and data/matio: .flo {flows.shape}, max "
        f"|flow| {np.abs(flows).max():.3f} px; .mat {warps.shape} in [0, 1]")
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
    flow_path, warp_path = os.path.join(tmp, "eval.flo"), os.path.join(tmp, "eval_warp.mat")
    flo.write_flo_5dim(flow, flow_path)
    mat_rates("[eval]", warp_path, lambda: matio.write_warp_mat(warp, warp_path),
                   lambda: matio.read_warp_mat(warp_path), "pred")
    t0 = time.perf_counter()
    res = evaluate.evaluate_test_set(runner, lr_dir, gt_dir, flow_path, warp_path, **kw)
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
    log(f"[eval] through evaluate_test_set (.flo/.mat files of the port's writers): one pass in "
        f"{seconds:.2f} s, peak {peak_gib:.2f} GiB")

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
    test_set = {"test_data_path": lr_dir, "test_label_path": gt_dir,
                "test_flow_data_path": flow_path, "test_warped_data_path": warp_path}
    return test_set


@contextlib.contextmanager
def torch_tf32_defaults():
    """PyTorch's own settings inside the block, which this script turns off at
    its start: TF32 for cuDNN's convolutions (not for cuBLAS's products)."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


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


def device_busy(fn, reps=2, names=()):
    """(ms the card is busy, CUDA kernels and copies) a call of `fn`, from
    torch.profiler: beside the call's wall time they say how far the host's
    launches hold the card back. Only the card's activity is traced. With
    `names`, a third item: {name: kernels a call whose name holds it}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_card = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        raise AssertionError("torch.profiler recorded no device activity")
    busy, kernels = sum(ev.device_time for ev in on_card) / 1e3 / reps, len(on_card) / reps
    if not names:
        return busy, kernels
    return busy, kernels, {n: sum(n in ev.name for ev in on_card) / reps for n in names}


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
    from fisr_tpu_torch.utils import profiling

    steps, batch_size = 6, 8
    store = synthetic_store(n_samples=steps * batch_size + 2, h=TRAIN_PATCH, w=TRAIN_PATCH,
                            seed=0, val_size=2)
    ckpt, logs = os.path.join(tmp, "train_ckpt"), os.path.join(tmp, "train_log")
    kw = dict(ckpt_dir=ckpt, log_dir=logs, batch_size=batch_size, val_batch_size=2,
              freq_display=2, policy=BF16, device="cuda")
    reset_launches(kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted = profiling.totals()["counters"].get("train.fisr_steps", 0)
    t0 = time.perf_counter()
    state = fit(store, epochs=1, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_fit = torch.cuda.max_memory_allocated() / 2**30
    require_launches(kernel, "fit (FISRnet has no kernel)", want=0)
    counted = profiling.totals()["counters"].get("train.fisr_steps", 0) - counted
    if counted != steps:
        raise AssertionError(f"fit ran {steps} steps, the counter train.fisr_steps {counted}")
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        rec = json.loads(f.read().splitlines()[-1])
    if state.step != steps or rec["step"] != steps or not np.isfinite(list(rec.values())).all():
        raise AssertionError(f"fit: step {state.step}, epoch record {rec}")
    mgr = CheckpointManager(ckpt)
    if mgr.latest_step() != steps:
        raise AssertionError(f"fit left checkpoint step {mgr.latest_step()}, want {steps}")
    log(f"[train] fit: {steps} steps of batch {batch_size} ({TRAIN_PATCH}x{TRAIN_PATCH} patches, "
        f"bf16; train.fisr_steps counted {counted}) + validation + checkpoint in "
        f"{seconds:.2f} s, peak {peak_fit:.2f} GiB; epoch means "
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
        if name == "f32":  # for the record: the same step with TF32 convolutions
            with torch_tf32_defaults():
                out[name]["ms_tf32"] = wall_ms(lambda: step(card, dev_batch))
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
        + f"; f32 as its policy runs it (TF32 off), and with PyTorch's TF32 convolutions "
          f"{out['f32']['ms_tf32']:.2f} ms a step"
        + f"; one stacked read-back of the 11 metrics {readback_ms:.3f} ms")
    return out["bf16"]["ms"]


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
            by_shape = [graph_time_ms(lambda: kernel.cost_volume_backward_cuda(a, b, grad, D))
                        for a, b, grad in graphs]
            out[impl]["graph_ms_by_shape"] = by_shape
            out[impl]["graph_ms"] = sum(by_shape)
    return out


def phase_pwc_train(tmp):
    from fisr_tpu_torch.convert import params
    from fisr_tpu_torch.data.flow_dataset import FlowDataset
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.models import pwcnet
    from fisr_tpu_torch.ops.conv import BF16, F32
    from fisr_tpu_torch.train import pwc_trainer, schedule, trainer
    from fisr_tpu_torch.device import cudnn_deterministic
    from fisr_tpu_torch.train.checkpoint import CheckpointManager
    from fisr_tpu_torch.train.pwc_loss import pwcnet_loss
    from fisr_tpu_torch.utils import profiling

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
    cv_names = ("cost_volume_kernel", "cost_volume_bwd")

    def graph_counters():
        c = profiling.totals()["counters"]
        return [c.get(k, 0) for k in ("train.steps", "train.graph_captures",
                                       "train.graph_replays")]

    def fresh_state():  # the rate halves from the fourth step, so its fill is checked too
        return pwc_trainer.create_pwc_state(
            0, trainer.tf_adam(schedule.multisteps([1e-4, 5e-5], [2])), device="cuda")

    for name, policy, variant in (("f32", F32, "fma_f32"), ("bf16", BF16, "mma_bf16")):
        # the step as pwc_fit and the benchmark run it (two eager calls, the
        # capture, then replays), held against the eager step on the same batch
        state, ref = fresh_state(), fresh_state()
        step = pwc_trainer.make_pwc_train_step(policy=policy)
        eager = pwc_trainer.make_pwc_train_step(policy=policy, graph=False)
        counted = graph_counters()
        losses, want = [], []
        with cudnn_deterministic():
            reset_launches(kernel)
            # a replay passes no wrapper: the launches are those of the first
            # three calls, the capturing one included
            with recorded_launches(kernel) as (seen, seen_bwd):
                for _ in range(3):
                    state, m = step(state, batch)
                    losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            what = f"pwc train step ({name}), its first 3 calls"
            require_launches(kernel, what, want=15, variant=variant)
            require_backward(kernel, what, want=15, variant=f"bwd_{name}")
            launches, bwd_launches = kernel.LAUNCHES // 3, kernel.BACKWARD_LAUNCHES // 3
            errs[name] = check_recorded(kernel, seen, 3 * level_shapes, what, seed=6)
            bwd_errs[name] = check_recorded(kernel, seen_bwd, 3 * level_shapes, what, seed=9,
                                            backward=True)
            for _ in range(3):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            for _ in range(6):
                ref, m = eager(ref, batch)
                want.append(float(m["loss"]))
            torch.cuda.synchronize()
        moved_by = [b - a for a, b in zip(counted, graph_counters())]
        if moved_by != [12, 1, 4]:
            raise AssertionError(f"pwc train step ({name}): steps, captures, replays moved by "
                                 f"{moved_by} in 6 graphed and 6 eager steps, want [12, 1, 4]")
        if losses != want:
            raise AssertionError(f"pwc train step ({name}), graphed against eager under "
                                 f"deterministic cuDNN: losses {losses} against {want}")
        for (k, p), q in zip(state.model.named_parameters(), ref.model.parameters()):
            same = [torch.equal(p, q)] + [torch.equal(state.optimizer.state[p][f],
                                                      ref.optimizer.state[q][f])
                                          for f in ("mu", "nu")]
            if not all(same):
                raise AssertionError(f"pwc train step ({name}), graphed against eager after 6 "
                                     f"steps: {k} (parameter, mu, nu) equal {same}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"pwc loss did not fall on one batch ({name}): {losses}")
        epe = float(pwc_trainer.make_pwc_eval_step(policy=policy)(state.model, val)["epe"])
        if not np.isfinite(epe):
            raise AssertionError(f"eval EPE ({name}): {epe}")
        # timed under the default flags, which the graph is bound to: the
        # warm-up calls make its capture anew
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(lambda: step(state, batch), warmup=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        eager_ms = wall_ms(lambda: eager(ref, batch))
        ms_tf32 = None
        if name == "f32":  # for the record: the same step with TF32 convolutions
            with torch_tf32_defaults():
                ms_tf32 = wall_ms(lambda: step(state, batch), warmup=3)

        # of an eager step, the time inside the cost volume's backward, by level
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
                ref, m = eager(ref, batch)
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
        # the card's work in replayed steps: the graph launches the kernels
        for _ in range(3):  # back under the default flags: captured anew
            state, m = step(state, batch)
        counted = graph_counters()
        busy, kernels, by_name = device_busy(lambda: step(state, batch), names=cv_names)
        moved_by = [b - a for a, b in zip(counted, graph_counters())]
        if moved_by != [2, 0, 2] or by_name != dict.fromkeys(cv_names, 5):
            raise AssertionError(f"pwc train step ({name}), 2 traced steps: steps, captures, "
                                 f"replays moved by {moved_by}, want [2, 0, 2]; cost-volume "
                                 f"kernels a step {by_name}, want 5 each")
        steps[name] = {"ms": ms, "eager_ms": eager_ms, "busy_ms": busy, "kernels": kernels,
                       "peak_gib": peak, "inside_backward_ms": inside, "launches": launches,
                       "bwd_launches": bwd_launches, "ms_tf32": ms_tf32}
        log(f"[pwc_train] {name}: the graphed step's first 3 calls made 15 {variant} and 15 "
            f"bwd_{name} launches, the kernels against the plain versions at their shapes "
            f"{[list(s) for s in level_shapes]}: max |diff| {errs[name]:.3g} forward, "
            f"{bwd_errs[name]:.3g} backward; 6 graphed steps (1 capture, 4 replays) bit-equal "
            f"to 6 eager ones in losses, parameters and moments under deterministic cuDNN, "
            f"across a halving of the rate; loss {losses[0]:.4f} -> {losses[-1]:.4f} over 6 "
            f"steps on one batch; eval EPE {epe:.4f}; {ms:.2f} ms a step replayed "
            + (f"(TF32 off, as the F32 policy runs it; {ms_tf32:.2f} with PyTorch's TF32 "
               f"convolutions) " if ms_tf32 is not None else "")
            + f"(batch 8 of {h}x{w}, {8e3 / ms:.1f} samples/s), {eager_ms:.2f} ms eager, peak "
            f"{peak:.2f} GiB; a replayed step keeps the card busy {busy:.2f} ms in "
            f"{kernels:.0f} kernels, 5 cost_volume_kernel and 5 cost_volume_bwd among them; "
            f"inside an eager step's cost-volume backward {inside:.2f} ms "
            f"({100 * inside / eager_ms:.0f} %), by level "
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
            f"{p['ms']:.3f} ms as its caller waits; by level, graph_ms against the byte bound: "
            + ", ".join(f"{lvl}: {t:.4f} / {cv_bwd_bound_ms(s, dtype)[0]:.4f}"
                        for lvl, t, s in zip(LEVEL_CHANNELS, k["graph_ms_by_shape"],
                                             level_shapes)))

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


CORPUS_FRAMES, CORPUS_SAMPLES = 17, 48  # 3 windows of 9 frames at stride 4


def store_step_ms(store, batch_size):
    """ms a bf16 train step (full-width FISRnet, fresh weights) fed from
    `store` as fit feeds it: the host gathers each batch, uploads it, steps;
    one epoch of warm-up, then one timed epoch."""
    from fisr_tpu_torch.convert import params
    from fisr_tpu_torch.ops.conv import BF16
    from fisr_tpu_torch.train import trainer

    model = params.deterministic_fisrnet(device="cuda")
    state = trainer.TrainState(model, trainer.tf_adam(1e-4)(model.parameters()))
    step = trainer.make_train_step(policy=BF16)
    for timed_epoch in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in store.batches(batch_size, epoch_seed=int(timed_epoch)):
            state, _ = step(state, trainer.batch_to_device(batch, "cuda"))
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / store.num_batches(batch_size)


def phase_corpus(pwc_ckpt, test_set, train_ms, tmp):
    """The reference's .mat workflows on the card, each through its CLI's
    main(argv) on cuda: build_corpus on CORPUS_FRAMES synthetic YUV frames of
    EVAL_INPUT with the converted full-width PWC-Net (f32), prepare
    flow-from-mat / warp-from-mat on its LR .mat (equal to build_corpus's
    files), --phase train on the corpus (full width, bf16, batch 8, 4 steps)
    with its test phase on [eval]'s test set, and --phase test from that
    checkpoint (the same scores). Returns the launches and the
    kernel-vs-plain |diff| at their shapes."""
    from fisr_tpu_torch import native
    from fisr_tpu_torch.cli import build_corpus, prepare
    from fisr_tpu_torch.cli import main as cli
    from fisr_tpu_torch.data import flo, matio
    from fisr_tpu_torch.data.dataset import TrainStore
    from fisr_tpu_torch.data.synth import synthetic_store
    from fisr_tpu_torch.kernels import cost_volume as kernel

    h, w = EVAL_INPUT
    frames_dir, out = os.path.join(tmp, "corpus_frames"), os.path.join(tmp, "corpus")
    os.makedirs(frames_dir)
    for i, fr in enumerate(synthetic_frames(CORPUS_FRAMES, h, w, seed=7)):
        native.encode_png(fr, os.path.join(frames_dir, f"frame_{i:03d}.png"))
    patch, batch_size, val = TRAIN_PATCH, 8, 16
    launches, seen_all, walls = {}, [], {}

    def run(tag, fn, argv, want):
        torch.cuda.synchronize()
        reset_launches(kernel)
        t0 = time.perf_counter()
        with recorded_launches(kernel) as (seen, _):
            result = fn(argv)
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        require_launches(kernel, tag, want=want, variant="fma_f32")
        launches[tag] = kernel.LAUNCHES
        seen_all.extend(seen)
        return result

    # 6 flow calls a sample (4 pairs at ss 1, 2 at ss 2), 5 launches a call
    paths = run("build_corpus", build_corpus.main,
                ["--frames", frames_dir, "--out", out, "--yuv", "--samples", str(CORPUS_SAMPLES),
                 "--patch", str(patch), "--pwc_ckpt", pwc_ckpt, "--device", "cuda"],
                30 * CORPUS_SAMPLES)
    flow_again, warp_again = os.path.join(tmp, "again_ss1.flo"), os.path.join(tmp, "again_warp.mat")
    run("flow_from_mat", prepare.main,
        ["flow-from-mat", "--mat", paths["data_path"], "--ss", "1", "--out", flow_again,
         "--pwc_ckpt", pwc_ckpt, "--device", "cuda"], 20 * CORPUS_SAMPLES)
    run("warp_from_mat", prepare.main,
        ["warp-from-mat", "--mat", paths["data_path"], "--flo", flow_again, "--ss", "1",
         "--out", warp_again, "--device", "cuda"], 0)
    hh = patch * FLOW_UPSCALE
    err = check_recorded(kernel, seen_all, [(2, hh >> lvl, hh >> lvl, c)
                                            for lvl, c in LEVEL_CHANNELS.items()]
                         * (6 + 4) * CORPUS_SAMPLES, "corpus", seed=11)
    flows = flo.read_flo_5dim(paths["flow_path"])
    if not np.array_equal(flo.read_flo_5dim(flow_again), flows):
        raise AssertionError("prepare flow-from-mat differs from build_corpus's ss1 .flo")
    warps = matio.read_warp_mat(paths["warp_path"])
    if not np.array_equal(matio.read_warp_mat(warp_again), warps):
        raise AssertionError("prepare warp-from-mat differs from build_corpus's ss1 _warp.mat")
    if flows.shape != (CORPUS_SAMPLES, 8, patch, patch, 2) or not np.isfinite(flows).all() or \
            warps.shape != (CORPUS_SAMPLES, 8, patch, patch, 3) or not np.isfinite(warps).all():
        raise AssertionError(f"corpus: flows {flows.shape}, warps {warps.shape}")
    log(f"[corpus] build_corpus on {CORPUS_FRAMES} YUV frames of {h}x{w}: {CORPUS_SAMPLES} "
        f"samples of {patch}x{patch} in {walls['build_corpus']:.2f} s, "
        f"{launches['build_corpus']} cost-volume launches; prepare flow-from-mat --ss 1 "
        f"{launches['flow_from_mat']} launches ({walls['flow_from_mat']:.2f} s), warp-from-mat "
        f"{launches['warp_from_mat']} ({walls['warp_from_mat']:.2f} s), all fma_f32; their "
        f".flo and _warp.mat equal to build_corpus's; the kernel against the plain version at "
        f"their shapes: max |diff| {err}")

    # the codec's rates at the corpus's size, and the store the train phase reads
    # C-contiguous [N, 7, 2h, 2w, 3] as build_corpus holds it (the reader's
    # view would make the writer's axis swap contiguous)
    hr = np.ascontiguousarray(matio.read_train_mat(paths["label_path"], "HR_data")) * np.float32(255)
    mat_rates("[corpus]", os.path.join(tmp, "hr_again.mat"),
                   lambda: matio.write_train_mat(os.path.join(tmp, "hr_again.mat"), "HR_data", hr),
                   lambda: matio.read_train_mat(os.path.join(tmp, "hr_again.mat"), "HR_data"),
                   "HR_data")
    del hr
    t0 = time.perf_counter()
    store = TrainStore.from_files(**paths, val_size=val)
    from_files_s = time.perf_counter() - t0
    memory = synthetic_store(n_samples=CORPUS_SAMPLES, h=patch, w=patch, seed=0, val_size=val)
    step_ms = {"file": store_step_ms(store, batch_size), "memory": store_step_ms(memory, batch_size)}
    log(f"[corpus] TrainStore.from_files on the six files: {from_files_s:.3f} s; a bf16 train "
        f"step (batch {batch_size}, fed as fit feeds it: gather, upload, step) on the "
        f"file-backed store {step_ms['file']:.2f} ms, on data/synth's in-memory store "
        f"{step_ms['memory']:.2f} ms; [train]'s step on a batch already on the card "
        f"{train_ms:.2f} ms")
    del store, memory

    args = ["--device", "cuda", "--checkpoint_dir", os.path.join(tmp, "corpus_ckpt"),
            "--log_dir", os.path.join(tmp, "corpus_log"), "--text_dir", os.path.join(tmp, "corpus_text"),
            "--test_img_dir", os.path.join(tmp, "corpus_img"),
            "--train_data_path", paths["data_path"], "--train_label_path", paths["label_path"],
            "--train_flow_data_path", paths["flow_path"],
            "--train_flow_ss2_data_path", paths["flow_ss2_path"],
            "--train_warped_data_path", paths["warp_path"],
            "--train_wapred_ss2_data_path", paths["warp_ss2_path"],
            "--batch_size", str(batch_size), "--val_data_size", str(val), "--epoch", "1",
            "--test_input_size", str(h), str(w)]
    args += [x for k, v in test_set.items() for x in (f"--{k}", v)]
    trained = run("train_phase", cli.main, ["--phase", "train"] + args, 0)
    tested = run("test_phase", cli.main, ["--phase", "test"] + args, 0)
    steps = (CORPUS_SAMPLES - val) // batch_size
    with open(os.path.join(tmp, "corpus_log", "FISRnet_exp1", "metrics.jsonl")) as f:
        rec = json.loads(f.read().splitlines()[-1])
    scores = lambda r: (r.psnr_vfi_sr, r.psnr_sr, r.ssim_vfi_sr, r.ssim_sr)
    if rec["step"] != steps or not np.isfinite(list(rec.values())).all() or \
            trained.n_frames != 7 or not np.isfinite(scores(trained)).all():
        raise AssertionError(f"--phase train: epoch record {rec}, test {trained}")
    if scores(tested) != scores(trained):
        raise AssertionError(f"--phase test from the checkpoint {scores(tested)} differs from "
                             f"the train phase's own test {scores(trained)}")
    log(f"[corpus] cli.main --phase train on the corpus (FISRnet ch=64, bf16, batch "
        f"{batch_size}, {steps} steps + validation + checkpoint, then the test phase on "
        f"[eval]'s {h}x{w} scene) {walls['train_phase']:.2f} s: val_PSNR {rec['val_PSNR']:.3f}, "
        f"test PSNR {trained.psnr_vfi_sr:.4f} / {trained.psnr_sr:.4f} dB, SSIM "
        f"{trained.ssim_vfi_sr:.6f} / {trained.ssim_sr:.6f}; --phase test from the checkpoint "
        f"{walls['test_phase']:.2f} s: the same scores")
    return {"launches": {k: launches[k] for k in ("build_corpus", "flow_from_mat",
                                                   "warp_from_mat")},
            "err": err}


def phase_trained(fisr, folder, tmp):
    """The repo's trained PWC-Net (an orbax store, checkpoint_dir/pwcnet) read
    without tensorstore or a zstd library: the read's time and MB/s, the
    tree's SHA-256 against TRAINED_PWC_SHA256, then the CLI's default restore
    onto the card and the fused main path with it (`trained_main_path`).
    Returns (the module, the path's launches)."""
    from fisr_tpu_torch.cli import main as cli
    from fisr_tpu_torch.convert import params
    from fisr_tpu_torch.convert.ocdbt import OcdbtStore
    from fisr_tpu_torch.convert.orbax_read import read_orbax_tree, tree_digest

    root = os.path.dirname(os.path.abspath(__file__))
    step = os.path.join(root, "checkpoint_dir", "pwcnet", "step_14000")
    read_orbax_tree(step)  # the page cache warm
    tree, ms = host_ms(lambda: read_orbax_tree(step), 3)
    digest = tree_digest(tree)
    if digest != TRAINED_PWC_SHA256:
        raise AssertionError(f"checkpoint_dir/pwcnet read with SHA-256 {digest}, not the pinned "
                             f"{TRAINED_PWC_SHA256}")
    stored = sum(len(v) for _, v in OcdbtStore(step).items())
    leaves = list(params.flatten_tree(tree))
    decoded = sum(a.nbytes for _, a in leaves)
    log(f"[trained] checkpoint_dir/pwcnet step 14000 read without tensorstore: {len(leaves)} "
        f"leaves, {stored / 1e6:.2f} MB stored (zstd chunks, .zarray) -> {decoded / 1e6:.2f} MB "
        f"in {ms:.1f} ms (host clock, median of 3, page cache warm, {os.cpu_count()} CPUs): "
        f"{stored / ms / 1e3:.0f} MB/s stored, {decoded / ms / 1e3:.0f} MB/s decoded; SHA-256 "
        f"{digest}, the pinned constant")
    args = cli.parse_args(["--checkpoint_dir", os.path.join(root, "checkpoint_dir")])
    pwc = cli._model(args, "cuda", "pwc")
    same_weights(pwc, params.pwcnet_from_jax(tree["params"], device="cuda"),
                 "the CLI's default PWC-Net restore")
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


def phase_prepare(pwc, which, ckpt_dir, tmp):
    """cli/prepare's test-set flow precompute on one scene of 5 frames at the
    main path's size, f32; returns the launches at ss=1 and ss=2, the
    largest kernel-vs-plain |diff| at their shapes and the ms a pair, with
    cuDNN's default algorithms and with its deterministic ones."""
    from fisr_tpu_torch.cli import prepare
    from fisr_tpu_torch.data import flo
    from fisr_tpu_torch.data.png_io import read_png, write_png
    from fisr_tpu_torch.device import cudnn_deterministic, exact_f32
    from fisr_tpu_torch.infer.video import make_flow_fn
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.ops.conv import F32

    h, w = WINDOW
    scene = os.path.join(tmp, "prepare_scene")
    os.makedirs(scene)
    for i, fr in enumerate(synthetic_frames(5, h, w, seed=5)):
        write_png(fr, os.path.join(scene, f"frame_{i:03d}.png"))
    launches, seen_all, walls = {}, [], {}
    # ss=1 and ss=2 under this script's global setting (TF32 off), then ss=1
    # again with PyTorch's TF32 defaults around the call: the entry point sets
    # its own f32 and determinism, so the two ss=1 files must be the same bits
    runs = (("ss1", 1, contextlib.nullcontext), ("ss2", 2, contextlib.nullcontext),
            ("ss1_tf32_defaults", 1, torch_tf32_defaults))
    for tag, ss, around in runs:
        out = os.path.join(tmp, f"prepare_{tag}.flo")
        torch.cuda.synchronize()
        reset_launches(kernel)
        t0 = time.perf_counter()
        with recorded_launches(kernel) as (seen, _), around():
            prepare.main(["flow-from-pngs", "--png_dir", scene, "--out", out,
                          "--pwc_ckpt", ckpt_dir, "--ss", str(ss)])
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        want = 20 if ss == 1 else 10
        require_launches(kernel, f"prepare flow-from-pngs --ss {ss} ({tag})", want=want,
                         variant="fma_f32")
        launches[tag], seen_all = kernel.LAUNCHES, seen_all + seen
    hh, ww = h * FLOW_UPSCALE, w * FLOW_UPSCALE
    err = check_recorded(kernel, seen_all, [(2, hh >> lvl, ww >> lvl, c)
                                            for lvl, c in LEVEL_CHANNELS.items()] * 10,
                         "prepare", seed=9)
    written = flo.read_flo_5dim(os.path.join(tmp, "prepare_ss1.flo"))
    again = flo.read_flo_5dim(os.path.join(tmp, "prepare_ss1_tf32_defaults.flo"))
    if not np.array_equal(written, again):
        raise AssertionError(f"prepare under PyTorch's TF32 defaults differs from the run under "
                             f"TF32 off: max |diff| {np.abs(written - again).max()}")
    seqs = np.stack([read_png(os.path.join(scene, f"frame_{i:03d}.png"))
                     for i in range(5)])[None].astype(np.float32)
    # the library function under the package's policy equals what the CLI wrote
    with exact_f32(), cudnn_deterministic():
        flows = prepare.flows_for_sequences(pwc, seqs, 1)
    if written.shape != (1, 8, h, w, 2) or not np.array_equal(written, flows):
        raise AssertionError(f"prepare .flo {written.shape} differs from flows_for_sequences "
                             f"{flows.shape}: max |diff| {np.abs(written - flows).max()}")
    warps = prepare.warps_for_sequences(seqs, flows, 1)
    if warps.shape != (1, 8, h, w, 3) or not np.isfinite(warps).all():
        raise AssertionError(f"prepare warps: shape {warps.shape} or non-finite values")
    flow_fn = make_flow_fn(pwc.cfg, F32)
    a, b = (torch.from_numpy(seqs[0, i:i + 1]).cuda() for i in (0, 1))
    pair_ms = {"default": time_ms(lambda: flow_fn(pwc, a, b), reps=5, warmup=1)}
    with cudnn_deterministic():
        pair_ms["deterministic"] = time_ms(lambda: flow_fn(pwc, a, b), reps=5, warmup=1)
    log(f"[prepare] flow-from-pngs on 5 frames of {h}x{w} with the {which} PWC-Net, f32: "
        f"{launches['ss1']} cost-volume launches at ss=1 ({walls['ss1']:.2f} s, PNG decode "
        f"included), {launches['ss2']} at ss=2 ({walls['ss2']:.2f} s), all fma_f32; the kernel "
        f"against the plain version at their shapes: max |diff| {err}; ss=1 again with "
        f"PyTorch's TF32 defaults around the call ({walls['ss1_tf32_defaults']:.2f} s): the "
        f"same bits; the .flo bit-equal to flows_for_sequences under exact_f32 and "
        f"cudnn_deterministic; warps finite; a pair (flow, f32, TF32 off) "
        f"{pair_ms['default']:.2f} ms with cuDNN's default algorithms, "
        f"{pair_ms['deterministic']:.2f} ms with its deterministic ones (what cli/prepare "
        "runs)")
    return launches, err, pair_ms


# stream step (rounds of B=2 windows) vs the single-card pair-cached loop
# (batch 1), bf16, in u8 counts: the same reasoning as STAGED_MAX_U8 (another
# batch size may take another cuDNN algorithm and bf16 summation order)
MULTI_MAX_U8, MULTI_MEAN_U8 = 4, 0.03


def phase_multi(fisr, pwc, tmp):
    """The multi-device layer on a world of one rank: an NCCL group started
    in this process on a file store under `tmp`, destroyed at the end of the
    phase whatever happens (the failure still fails the script)."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "nccl_store"), 1),
                            rank=0, world_size=1)
    try:
        return multi_device(fisr, pwc, tmp)
    finally:
        dist.destroy_process_group()


def multi_device(fisr, pwc, tmp):
    import threading
    import urllib.request
    import zlib

    import torch.distributed as dist

    from fisr_tpu_torch.core import mesh
    from fisr_tpu_torch.data.flow_dataset import FlowDataset
    from fisr_tpu_torch.data.synth import synthetic_store
    from fisr_tpu_torch.device import cudnn_deterministic
    from fisr_tpu_torch.infer import serving, sharded
    from fisr_tpu_torch.infer.daemon import (FISRService, MultiChipService, make_server,
                                             pack_frames, unpack_frames)
    from fisr_tpu_torch.infer.tiled import TiledRunner
    from fisr_tpu_torch.infer.video import (make_fisr_window_fn, make_fused_video_step,
                                            make_pair_fn)
    from fisr_tpu_torch.kernels import cost_volume as kernel
    from fisr_tpu_torch.ops.conv import BF16, F32
    from fisr_tpu_torch.train import pwc_trainer, trainer
    from fisr_tpu_torch.train.loop import fit

    clock = [time.perf_counter()]

    def say(line):
        """log `line` with the seconds since the last line"""
        now = time.perf_counter()
        log(f"{line} [{now - clock[0]:.1f} s]")
        clock[0] = now

    m = mesh.make_mesh((1, 1), device="cuda")
    say(f"[multi] {torch.cuda.device_count()} card(s) visible, world size "
        f"{dist.get_world_size()} ({dist.get_backend()}), mesh "
        f"{dict(zip(m.mesh_dim_names, m.shape))}: every collective runs on one rank; no "
        f"scaling across cards is measured")
    h, w = WINDOW
    launches = {}
    quant = FISRService._quant

    # the pair-cached stream step, ragged: 5 windows (7 frames) in rounds of 2
    seq = torch.from_numpy(synthetic_frames(7, h, w, seed=5)).cuda().float()
    windows = torch.stack([seq[k:k + 3] for k in range(5)])
    step = serving.make_frame_parallel_stream_step(m, policy=BF16, upscale=FLOW_UPSCALE,
                                                   cfg=pwc.cfg, ragged=True)
    pair_fn = make_pair_fn(pwc.cfg, BF16, FLOW_UPSCALE)
    reset_launches(kernel)
    with torch.inference_mode(), recorded_launches(kernel) as (seen, _):
        carry = pair_fn(pwc, seq[None, 0], seq[None, 1])
        got, per_round = [], []
        for r0 in (0, 2, 4):
            before = kernel.LAUNCHES
            padded, n_valid = serving.pad_stream_round(windows[r0:r0 + 2], 2)
            pred, carry = step(fisr, pwc, padded, carry, n_valid)
            got.append(quant(pred[:n_valid]))
            per_round.append(kernel.LAUNCHES - before)
    torch.cuda.synchronize()
    require_launches(kernel, "stream step (seed pair + 3 rounds of 2)", want=20)
    if per_round != [5, 5, 5]:
        raise AssertionError(f"stream step launches a round: {per_round}, want 5 each")
    launches["stream_round"] = per_round[0]
    level_shapes = [(b, (FLOW_UPSCALE * h) >> lvl, (FLOW_UPSCALE * w) >> lvl, c)
                    for b in (2, 4, 4, 4) for lvl, c in LEVEL_CHANNELS.items()]
    err_bf16 = check_recorded(kernel, seen, level_shapes, "stream step", seed=21)
    win_fn = make_fisr_window_fn(BF16)
    with torch.inference_mode():  # the single-card loop of FISRService.stream_frame
        prev, want = pair_fn(pwc, seq[None, 0], seq[None, 1]), []
        for k in range(5):
            new = pair_fn(pwc, seq[None, k + 1], seq[None, k + 2])
            want.append(quant(win_fn(fisr, windows[k:k + 1], prev, new)))
            prev = new
        got_u8 = torch.cat(got).cpu().numpy()
        want_u8 = torch.cat(want).cpu().numpy()
        carry_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(carry, prev))
        # the frames move at a constant speed, so every pair has the same flow:
        # the warps tell the pairs apart
        wrong_err = float((carry[1] - pair_fn(pwc, seq[None, 4], seq[None, 5])[1]).abs().max())
    stream_diff = u8_diff(got_u8, want_u8)
    if (got_u8.shape != (5, 2 * h, 2 * w, 9) or stream_diff[0] > MULTI_MAX_U8
            or stream_diff[1] > MULTI_MEAN_U8 or not carry_err < wrong_err):
        raise AssertionError(f"stream step vs the single-card loop: shape {got_u8.shape}, (max, "
                             f"mean u8) {stream_diff}, carry vs pair (5, 6) {carry_err}, vs "
                             f"pair (4, 5) {wrong_err}")
    rounds = []
    with torch.inference_mode():
        for _ in range(3):
            t0 = time.perf_counter()
            pred, _ = step(fisr, pwc, windows[:2], carry, 2)
            quant(pred).cpu()
            rounds.append(time.perf_counter() - t0)
    round_ms = spread_ms(rounds[1:])
    say(f"[multi] stream step: 5 windows in rounds of 2 (2, 2, 1 valid of 2), "
        f"{per_round} mma_bf16 launches a round + 5 for the seed pair = 20; vs the single-card "
        f"loop (max, mean u8) {stream_diff} (bounds {MULTI_MAX_U8}, {MULTI_MEAN_U8}); carry vs "
        f"pair (5, 6) max |diff| {carry_err:.3g} (its warps vs pair (4, 5)'s {wrong_err:.3g}); "
        f"kernel vs plain "
        f"at the {len(dict.fromkeys(seen))} launched shapes {err_bf16:.3g}; a round of 2 windows "
        f"median {round_ms['median_ms']:.2f} ms (min {round_ms['min_ms']:.2f}, max "
        f"{round_ms['max_ms']:.2f}, n {round_ms['n']}), a valid window "
        f"{round_ms['median_ms'] / 2:.2f} ms (min {round_ms['min_ms'] / 2:.2f}, max "
        f"{round_ms['max_ms'] / 2:.2f})")

    # the frame-parallel video step on 2 windows against the fused step
    vstep = serving.make_frame_parallel_video_step(m, policy=BF16, cfg=pwc.cfg,
                                                   upscale=FLOW_UPSCALE)
    fused = make_fused_video_step(pwc.cfg, BF16, FLOW_UPSCALE)
    reset_launches(kernel)
    with torch.inference_mode(), cudnn_deterministic():
        got = vstep(fisr, pwc, windows[:2])
        torch.cuda.synchronize()
        require_launches(kernel, "frame-parallel video step (2 windows)", want=10)
        launches["video_step"] = kernel.LAUNCHES
        same = torch.equal(got, fused(fisr, pwc, windows[:2]))
    if not same or got.shape != (2, 2 * h, 2 * w, 9):
        raise AssertionError(f"video step {tuple(got.shape)} differs from the fused step")
    say(f"[multi] frame-parallel video step: 2 windows, {launches['video_step']} mma_bf16 "
        f"launches, equal to make_fused_video_step")

    # the halo-sharded runner on a 1-wide spatial axis: both halos are zeros
    g = torch.Generator(device="cuda").manual_seed(7)
    inp = torch.rand((1, h, w, 29), device="cuda", generator=g)
    runner = sharded.make_sharded_runner(m, boundary=32, policy=BF16)
    reset_launches(kernel)
    with torch.inference_mode(), cudnn_deterministic():
        got = runner(fisr, inp)
        padded = torch.nn.functional.pad(inp, (0, 0, 32, 32)).cpu().numpy()
        want = TiledRunner(fisr, grid=(1, 1), boundary=32, policy=BF16, mode="padded",
                           device="cuda")(padded)[:, :, 64:-64]
    require_launches(kernel, "sharded runner (FISRnet has no kernel)", want=0)
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("sharded runner (n = 1) differs from the zero-padded (1, 1) tiling")
    with torch.inference_mode():
        sharded_ms = time_ms(lambda: runner(fisr, inp), reps=3, warmup=1)
    say(f"[multi] sharded runner, spatial axis of 1: {tuple(got.shape)}, equal to "
        f"TiledRunner((1, 1), 'padded') on the frame zero-padded by 32 columns a side; "
        f"{sharded_ms:.2f} ms a window")

    # data-parallel PWC-Net step (f32) against the same step without a mesh
    ph, pw = PWC_CROP
    ds = FlowDataset.synthetic_textured(n=10, h=ph, w=pw, seed=0, val_split=0.2)
    batch = next(ds.batches(8, train=True, epoch_seed=0))
    dp, dp_ms = {}, {}
    for name, on in (("single", None), ("mesh", m)):
        state = pwc_trainer.create_pwc_state(0, trainer.tf_adam(1e-4), device="cuda")
        step_fn = pwc_trainer.make_pwc_train_step(policy=F32, mesh=on, graph=False)
        b = mesh.shard_batch(batch, m) if on is not None else trainer.batch_to_device(batch, "cuda")
        reset_launches(kernel)
        with cudnn_deterministic(), recorded_launches(kernel) as (seen, seen_bwd):
            state, met = step_fn(state, b)
        torch.cuda.synchronize()
        if on is not None:
            require_launches(kernel, "data-parallel pwc train step", want=5, variant="fma_f32")
            require_backward(kernel, "data-parallel pwc train step", want=5, variant="bwd_f32")
            launches["pwc_train_step_dp"] = kernel.LAUNCHES
            shapes = [(8, ph >> lvl, pw >> lvl, c) for lvl, c in LEVEL_CHANNELS.items()]
            err_f32 = check_recorded(kernel, seen, shapes, "dp pwc step", seed=22)
            bwd_err = check_recorded(kernel, seen_bwd, shapes, "dp pwc step", seed=23,
                                     backward=True)
        dp[name] = (float(met["loss"]), snapshot(state.model))
        dp_ms[name] = wall_ms(lambda: step_fn(state, b))
    same = dp["single"][0] == dp["mesh"][0] and all(
        torch.equal(a, b) for a, b in zip(dp["single"][1], dp["mesh"][1]))
    if not same:
        raise AssertionError(f"data-parallel pwc step on one rank: loss {dp['mesh'][0]} vs "
                             f"{dp['single'][0]}, parameters bit-equal {same}")
    say(f"[multi] make_pwc_train_step(mesh=), batch 8 of {ph}x{pw}, f32: 5 fma_f32 and 5 "
        f"bwd_f32 launches, loss and parameters bit-equal to the step without a mesh (cuDNN "
        f"deterministic); {dp_ms['mesh']:.2f} ms a step with the mesh, {dp_ms['single']:.2f} "
        f"without: the one-rank all-reduces cost {dp_ms['mesh'] - dp_ms['single']:.2f} ms")
    store = synthetic_store(n_samples=2 * 8 + 2, h=32, w=32, seed=0, val_size=2)
    kw = dict(ckpt_dir=os.path.join(tmp, "dp_ckpt"), log_dir=os.path.join(tmp, "dp_log"),
              batch_size=8, val_batch_size=2, freq_display=1, policy=BF16, mesh=m)
    t0 = time.perf_counter()
    state = fit(store, epochs=1, **kw)
    resumed = fit(store, epochs=1, **kw)
    if not (state.step == resumed.step == 2 and all(
            torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                              resumed.model.parameters()))):
        raise AssertionError(f"fit(mesh=): steps {state.step}, {resumed.step}")
    say(f"[multi] fit(mesh=): 2 steps of batch 8 of 32x32 (bf16) + validation + checkpoint, "
        f"then a resume bit-equal to it, {time.perf_counter() - t0:.2f} s")
    del state, resumed

    # MultiChipService over one card named twice, behind the HTTP server
    fisr16 = copy.deepcopy(fisr).to(torch.bfloat16)  # as cli/serve casts it
    t0 = time.perf_counter()
    multi = MultiChipService(fisr16, pwc, h, w, devices=["cuda:0", "cuda:0"], policy=BF16,
                             fisr_grid="auto", upscale=FLOW_UPSCALE)
    build_s = time.perf_counter() - t0
    server = make_server(multi, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, frames_):
        req = urllib.request.Request(url + path, data=pack_frames(frames_))
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()

    try:
        frames = list(synthetic_frames(4, h, w, seed=9))
        reset_launches(kernel)
        code, body = post("/v1/window", frames[:3])
        require_launches(kernel, "MultiChipService /v1/window", want=10)
        launches["window"] = kernel.LAUNCHES
        if code != 200 or not all(np.array_equal(a, b) for a, b in zip(
                unpack_frames(body), multi.services[0].window(frames[:3]))):
            raise AssertionError("MultiChipService /v1/window differs from FISRService.window")
        ids = [f"cam{i}" for i in range(8)]
        ids = [ids[0], next(i for i in ids if zlib.crc32(i.encode()) % 2
                            != zlib.crc32(ids[0].encode()) % 2)]
        ref, stream_diffs = [multi.services[0].stream_frame("ref", f) for f in frames], []
        multi.services[0].drop_stream("ref")
        for sid in ids:
            outs = []
            for k, f in enumerate(frames):
                reset_launches(kernel)
                code, body = post(f"/v1/stream/{sid}/frame", [f])
                if k >= 2:
                    require_launches(kernel, "MultiChipService steady stream frame", want=5)
                outs.append(unpack_frames(body) if code == 200 else None)
            stream_diffs += [u8_diff(a, b) for o, r in zip(outs[2:], ref[2:]) for a, b in zip(o, r)]
        launches["stream_frame"] = kernel.LAUNCHES
        placed = [multi.services.index(multi._for_stream(i)) for i in ids]
        if max(d[0] for d in stream_diffs) > 1 or placed != [0, 1] and placed != [1, 0]:
            raise AssertionError(f"MultiChipService streams on {placed} vs a single service's: "
                                 f"{stream_diffs}")
        with urllib.request.urlopen(url + "/v1/info", timeout=60) as r:
            info = json.loads(r.read())
        # windows: 1 posted, 1 compared, 2 of the reference stream, 2 a stream
        if info["chips"] != 2 or info["stats"]["windows"] != 1 + 1 + 2 + 2 * 2:
            raise AssertionError(f"/v1/info: {info}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    say(f"[multi] MultiChipService over cuda:0 twice ('auto' grid, built and warmed up "
        f"concurrently in {build_s:.2f} s): /v1/window {launches['window']} launches, equal to "
        f"FISRService.window; streams {ids} on services {placed}, {launches['stream_frame']} "
        f"launches a steady frame, vs a single service's stream (max u8) "
        f"{max(d[0] for d in stream_diffs)}; /v1/info chips {info['chips']}")
    del multi, fisr16
    return {"launches": launches, "err_bf16": err_bf16, "err_f32": err_f32, "bwd_err": bwd_err,
            "round_ms": round_ms,
            "sharded_ms": sharded_ms, "dp_ms": dp_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # the entry points set exact f32 themselves (fisr_tpu_torch/device.py);
    # the phases below also call library functions directly under F32, and
    # hold them to the same f32 ([prepare] checks an entry point with
    # PyTorch's defaults restored around it)
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
    with tempfile.TemporaryDirectory() as tmp:
        timed(phase_native, tmp)
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
        test_set = timed(phase_eval, fisr, tmp)
        train_ms = timed(phase_train, tmp)
        pwc_train = timed(phase_pwc_train, tmp)
        converted_pwc = timed(phase_weights, fisr, pwc, tmp)
        corpus = timed(phase_corpus, converted_pwc, test_set, train_ms, tmp)
        trained_pwc, launches_trained = timed(phase_trained, fisr, folder, tmp)
        launches_prepare, err_prepare, prepare_pair_ms = timed(
            phase_prepare, trained_pwc, "trained (checkpoint_dir/pwcnet)", os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "checkpoint_dir", "pwcnet"), tmp)
        multi = timed(phase_multi, fisr, pwc, tmp)
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
        # the fused main path on the repo's trained PWC-Net (checkpoint_dir/pwcnet)
        "launches_trained": launches_trained,
        # the multi phase on a world of one rank: a round of the frame-parallel
        # stream step, the frame-parallel video step on 2 windows, a
        # MultiChipService /v1/window and steady stream frame
        "launches_multi": {k: multi["launches"][k]
                           for k in ("stream_round", "video_step", "window", "stream_frame")},
        # over the inference window's level shapes, the ragged shapes, the
        # shapes that the pwc_train and joint steps launched (f32 and bf16)
        # and those of the multi phase's stream step
        "max_abs_err": max(max_err, err_pwc_train, err_joint, multi["err_bf16"]),
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
                           "joint_step": launches_joint,
                           "pwc_train_step_dp": multi["launches"]["pwc_train_step_dp"]},
        # cli/prepare flow-from-pngs, one scene of 5 frames of 1024x1920
        "launches_prepare": {"ss1": launches_prepare["ss1"], "ss2": launches_prepare["ss2"]},
        # the corpus phase: cli/build_corpus (48 samples of 96x96), cli/prepare
        # flow-from-mat --ss 1 and warp-from-mat on its LR .mat
        "launches_corpus": corpus["launches"],
        # an f32 flow pair at 1024x1920 with cuDNN's default algorithms, and
        # with its deterministic ones (what cli/prepare runs)
        "prepare_pair_ms": prepare_pair_ms["default"],
        "prepare_pair_deterministic_ms": prepare_pair_ms["deterministic"],
        # the inference level shapes, the ragged shapes, the training, prepare and corpus shapes
        "max_abs_err": max([r["f32_err"] for r in levels] + [pwc_train["errs"]["f32"],
                                                             err_prepare, corpus["err"],
                                                             multi["err_f32"]]),
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
        # the TPU kernel's VJP, _cv_bwd (an XLA composition in the JAX package)
        "replaces": "fisr_tpu/kernels/cost_volume_pallas.py:81",
        "launches": pwc_train["steps"]["f32"]["bwd_launches"],
        "launches_train": {"pwc_train_step": pwc_train["steps"]["f32"]["bwd_launches"],
                           "joint_step": bwd_launches_joint["both"],
                           "joint_step_flow_frozen": bwd_launches_joint["frozen"],
                           "pwc_train_step_dp": multi["launches"]["pwc_train_step_dp"]},
        # the ragged shapes and the shapes the pwc_train, joint and
        # data-parallel pwc steps launched
        "max_abs_err": max(bwd_err_ragged, pwc_train["bwd_err"], bwd_err_joint,
                           multi["bwd_err"]),
        # one backward at each of the five pwc_train level shapes, f32 (bf16 beside)
        "ms": backward["f32"]["kernel"]["ms"],
        "graph_ms": backward["f32"]["kernel"]["graph_ms"],
        # levels 2..6 of the pwc_train step: graph_ms, and the byte bound
        "graph_ms_by_level": dict(zip(LEVEL_CHANNELS,
                                      backward["f32"]["kernel"]["graph_ms_by_shape"])),
        "bound_ms_by_level": {lvl: cv_bwd_bound_ms(s, torch.float32)[0]
                              for lvl, s in zip(LEVEL_CHANNELS, pwc_shapes)},
        "busy_ms": backward["f32"]["kernel"]["busy_ms"],
        "kernels": backward["f32"]["kernel"]["kernels"],
        "plain_ms": backward["f32"]["plain"]["ms"],
        "plain_busy_ms": backward["f32"]["plain"]["busy_ms"],
        "plain_kernels": backward["f32"]["plain"]["kernels"],
        "bound_ms": sum(cv_bwd_bound_ms(s, torch.float32)[0] for s in pwc_shapes),
        "bound_by": "bytes" if all(cv_bwd_bound_ms(s, torch.float32)[1] == "bytes"
                                   for s in pwc_shapes) else "operations",
        "bf16": {"launches": pwc_train["steps"]["bf16"]["bwd_launches"],
                 "ms": backward["bf16"]["kernel"]["ms"],
                 "graph_ms": backward["bf16"]["kernel"]["graph_ms"],
                 "graph_ms_by_level": dict(zip(LEVEL_CHANNELS,
                                               backward["bf16"]["kernel"]["graph_ms_by_shape"])),
                 "bound_ms_by_level": {lvl: cv_bwd_bound_ms(s, torch.bfloat16)[0]
                                       for lvl, s in zip(LEVEL_CHANNELS, pwc_shapes)},
                 "busy_ms": backward["bf16"]["kernel"]["busy_ms"],
                 "plain_ms": backward["bf16"]["plain"]["ms"],
                 "plain_busy_ms": backward["bf16"]["plain"]["busy_ms"],
                 "bound_ms": sum(cv_bwd_bound_ms(s, torch.bfloat16)[0] for s in pwc_shapes),
                 "bound_by": "bytes" if all(cv_bwd_bound_ms(s, torch.bfloat16)[1] == "bytes"
                                            for s in pwc_shapes) else "operations"},
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
