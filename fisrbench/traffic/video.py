"""Offline video traffic: an FISR_for_video job, PNG in to PNG out.

Set-up makes both models' weights on the card from the seed, one clip of
YUV PNG frames (harness/scene.py) in a temporary directory, and runs the
pipeline once over the clip's first frames, which warms up every shape the
window uses. The window runs the clip through
`fisr_tpu_torch.infer.video.run_video_pipeline` back to back, each time into
a new output folder, until `--seconds` have passed; the clip in progress is
finished. After each clip one window, drawn from the seed, keeps its four
files (RGB and YUV of its two new frames) for the check, and the rest is
deleted. A traced run traces one more clip after the window; its host CPU
time a frame is read over the window's untraced clips.

Mix parameters: frames (per clip), frame_hw, pan_px, objects, obj_radius,
obj_px, fisr_grid (null = full frame), check_windows (how many kept windows
the reference recomputes) and limits.

`control` puts the reference, at a lower precision, in the program's place
(harness/controls.py); `tiny` cuts a cell to a CPU test's size.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fisrbench.harness import scene, work
from fisrbench.harness.runner import Outcome, RunContext, Window, cpu_seconds, \
    device_generator, load_into, peak_bytes, seeded_params, sync
from fisrbench.harness.trace import Spans, traced
from fisrbench.reference import png
from fisrbench.reference.fisrnet import FISRnetRef
from fisrbench.reference.fisrnet import param_shapes as fisr_shapes
from fisrbench.reference.ops import Numerics, yuv2rgb_u8
from fisrbench.reference.pwcnet import PWCNetRef
from fisrbench.reference.pwcnet import param_shapes as pwc_shapes
from fisrbench.reference.video import padded_plan, window_u8


def weights(ctx: RunContext):
    """Both models' weights, drawn on the device from the configuration's
    `weights_seed`: the model is part of the configuration, and a random
    network's output statistics (how much of the frame saturates, so how
    well its PNGs compress, so how long the host encodes) vary with the draw.
    The traffic (clips, windows, samples checked) comes from --seed."""
    fc, pc = ctx.config["fisrnet"], ctx.config["pwcnet"]
    seed = ctx.config["weights_seed"]
    return (seeded_params(fisr_shapes(fc["in_ch"], fc["ch"], fc["sf"]),
                          device_generator(ctx.device, seed, 1), ctx.device),
            seeded_params(pwc_shapes(**pc), device_generator(ctx.device, seed, 2), ctx.device))


TINY = dict(frames=5, frame_hw=[70, 96], obj_radius=[5, 12], obj_px=[1.0, 3.0], pan_px=1.0,
            check_windows=2)


def tiny(config: dict, mix: dict):
    """The cell cut to a CPU test's size: narrow FISRnet, float32 (the
    program's CPU path), small frames."""
    config = dict(config, fisrnet=dict(config["fisrnet"], ch=8), compute_dtype="float32")
    return config, dict(mix, **TINY)


def models(ctx: RunContext):
    """(program FISRnet, program PWC-Net, policy, benchmark's weights of both)."""
    from fisr_tpu_torch.models import fisrnet, pwcnet
    from fisr_tpu_torch.ops.conv import BF16, F32

    fc, pc = ctx.config["fisrnet"], ctx.config["pwcnet"]
    fisr_p, pwc_p = weights(ctx)
    fisr = fisrnet.FISRnet(in_ch=fc["in_ch"], sf=fc["sf"], ch=fc["ch"], seed=0,
                           device=ctx.device)
    load_into(fisr, fisr_p)
    pwc = pwcnet.PWCNet(pwcnet.PWCNetConfig(**pc), seed=0, device=ctx.device)
    load_into(pwc, pwc_p)
    policy = {"bfloat16": BF16, "float32": F32}[ctx.config["compute_dtype"]]
    return fisr, pwc, policy, fisr_p, pwc_p


def scene_frames(ctx: RunContext, n: int) -> np.ndarray:
    """n YUV frames [n, h, w, 3] u8 of the mix's scene, from the seed."""
    mix = ctx.mix
    h, w = mix["frame_hw"]
    return scene.clip(ctx.generator(3), n, h, w, mix["pan_px"], mix["objects"],
                      tuple(mix["obj_radius"]), tuple(mix["obj_px"]), ctx.device).cpu().numpy()


def make_clip(ctx: RunContext, folder: str) -> np.ndarray:
    """The clip's YUV frames as PNGs in `folder`; returns them [n, h, w, 3] u8."""
    frames = scene_frames(ctx, ctx.mix["frames"])
    os.makedirs(folder)

    def write(i):
        with open(os.path.join(folder, f"frame_{i:04d}.png"), "wb") as f:
            f.write(png.encode(frames[i]))

    with ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(write, range(len(frames))))
    return frames


def _names(fr: int, digits: int):
    """The four files of window `fr`: its two new frames, RGB and YUV."""
    out = []
    for s in (0, 1):
        idx = str(2 * fr + s).zfill(digits)
        out += [f"pred_{idx}.png", f"pred_YUV_{idx}.png"]
    return out


def run(ctx: RunContext) -> Outcome:
    from fisr_tpu_torch.infer.video import run_video_pipeline

    mix, cfg = ctx.mix, ctx.config
    tmp = tempfile.mkdtemp(prefix="fisrbench-video-")
    try:
        fisr, pwc, policy, fisr_p, pwc_p = models(ctx)
        in_dir = os.path.join(tmp, "in")
        frames = make_clip(ctx, in_dir)
        n = len(frames)
        digits = _digits(n)
        per_clip = 2 * (n - 2) + 1  # output frames a clip writes (RGB; YUV beside)

        def clip_into(out):
            return run_video_pipeline(fisr, pwc, in_dir, out, policy=policy, fused=True,
                                      flow_upscale=cfg["flow_upscale"],
                                      fisr_grid=mix["fisr_grid"], verbose=False,
                                      device=ctx.device)

        warm = os.path.join(tmp, "warm")
        run_video_pipeline(fisr, pwc, in_dir, warm, policy=policy, fused=True,
                           flow_upscale=cfg["flow_upscale"], fisr_grid=mix["fisr_grid"],
                           frame_num=4, verbose=False, device=ctx.device)
        shutil.rmtree(warm)
        sync(ctx.device)
        setup_s = time.perf_counter() - ctx.t_start

        pick = ctx.rng(4)
        spans, keep = Spans(), []
        attempted = failed = written = 0

        def one_clip(k):
            """Run clip k; keep the files of one window drawn from the seed."""
            nonlocal attempted, failed, written
            out = os.path.join(tmp, f"out_{k}")
            with spans.span("run_video_pipeline"):
                clip_into(out)
            names = os.listdir(out)
            attempted += per_clip
            failed += per_clip - sum(1 for f in names if f.startswith("pred_YUV_"))
            written += sum(os.path.getsize(os.path.join(out, f)) for f in names)
            fr = int(pick.integers(0, n - 2))
            kdir = os.path.join(tmp, f"keep_{k}")
            os.makedirs(kdir)
            for f in _names(fr, digits):
                if f in names:
                    os.rename(os.path.join(out, f), os.path.join(kdir, f))
            keep.append((fr, kdir))
            shutil.rmtree(out)

        cpu0 = cpu_seconds()
        window = Window(ctx.seconds, ctx.device).open()
        k, clip_s = 0, []
        while True:
            t_clip = time.perf_counter()
            one_clip(k)
            clip_s.append(round(time.perf_counter() - t_clip, 3))
            k += 1
            if window.done():
                break
        elapsed = window.close()
        cpu_s = cpu_seconds() - cpu0
        frames_out = k * per_clip - failed
        print(f"video: {k} clips, {frames_out} frames in {elapsed:.3f} s, "
              f"{written} bytes written ({written / k:.0f} a clip); clips took {clip_s} s",
              file=sys.stderr)
        reading = {}
        if ctx.trace:  # one more clip after the window, traced
            clips = iter(range(k, k + 3))
            tr = traced(lambda: one_clip(next(clips)), spans,
                        {"cost_volume_kernel": CV_LAUNCHES_PER_PAIR * (n - 1)})
            reading = _reading(ctx, tr, n, per_clip, cpu_s, k)
        peak = peak_bytes(ctx.device)
        del fisr, pwc
        gc.collect()
        torch.cuda.empty_cache()

        checks, bad = check(ctx, frames, keep, digits, fisr_p, pwc_p)
        return Outcome(setup_s=setup_s, e2e={"video_fps": frames_out / elapsed},
                       attempted=attempted, failed=failed + bad, checks=checks,
                       memory_peak_bytes=peak, reading=reading)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


CV_LAUNCHES_PER_PAIR = 5  # a pair's flow in both directions: one launch a pyramid level


def _digits(n: int) -> int:
    """Digits of the output frame numbers of an n-frame clip."""
    return int(np.ceil(np.log10(2 * (n - 1))))


def _reading(ctx, tr, n, per_clip, cpu_s, clips_untraced) -> dict:
    cfg = ctx.config
    h, w = ctx.mix["frame_hw"]
    h, w = h - h % 32, w - w % 32
    up = cfg["flow_upscale"]
    levels = work.pwc_level_shapes(2, h * up, w * up, cfg["pwcnet"])
    dtype = cfg["compute_dtype"]
    return {
        "trace": tr,
        "units": {"frames": per_clip, "windows": n - 2, "pairs": n - 1},
        "cpu_s": cpu_s,
        "cpu_units": {"frames": per_clip * clips_untraced} if cpu_s is not None else None,
        "flops": {"pairs": work.pwc_flops(1, h * up, w * up, cfg["pwcnet"], directions=2),
                  "windows": work.fisr_flops(1, h, w, cfg["fisrnet"])},
        "peak_flops": work.PEAK_FLOPS[dtype],
        "cv_fwd": {"kernel": "cost_volume_kernel", "launches_per_cycle": len(levels),
                   "bound_s_per_cycle": sum(work.cv_bound_s(s, dtype) for s in levels)},
    }


def reference_nets(ctx, fisr_p, pwc_p, numerics: str = "exact"):
    fc = ctx.config["fisrnet"]
    return (FISRnetRef(fisr_p, fc["sf"], Numerics(numerics)),
            PWCNetRef(pwc_p, numerics=Numerics(numerics), **ctx.config["pwcnet"]))


def plan(mix: dict, h: int, w: int):
    """The window plan a mix's fisr_grid names, for the reference."""
    g = mix.get("fisr_grid")
    if g is None:
        return None
    if g == "auto":
        return padded_plan(h, w)
    return tuple(g), (0, 0)


@torch.inference_mode()
def reference_window(ctx, nets, frames, fr, rounding="trunc"):
    """The reference's u8 [2h, 2w, 9] for window fr of the clip."""
    h, w = frames.shape[1] - frames.shape[1] % 32, frames.shape[2] - frames.shape[2] % 32
    f = [torch.from_numpy(frames[fr + i, :h, :w]).to(ctx.device).float()[None]
         for i in range(3)]
    with nets[0].nx.backend():
        return window_u8(*nets, *f, upscale=ctx.config["flow_upscale"], rounding=rounding,
                         plan=plan(ctx.mix, h, w)).cpu().numpy()


def control(ctx, numerics: str):
    """`check` of the reference at `numerics` in the program's place: its
    files of `check_windows` windows drawn as a run keeps them."""
    frames = scene_frames(ctx, ctx.mix["frames"])
    n, digits = len(frames), _digits(len(frames))
    fisr_p, pwc_p = weights(ctx)
    low = reference_nets(ctx, fisr_p, pwc_p, numerics)
    pick, keep = ctx.rng(4), []
    tmp = tempfile.mkdtemp(prefix="fisrbench-control-")
    try:
        for k in range(ctx.mix["check_windows"]):
            fr = int(pick.integers(0, n - 2))
            out = reference_window(ctx, low, frames, fr)
            kdir = os.path.join(tmp, f"keep_{k}")
            os.makedirs(kdir)
            names = _names(fr, digits)
            for s in (0, 1):
                yuv = out[..., 3 * s:3 * s + 3]
                for name, img in ((names[2 * s], yuv2rgb_u8(yuv)), (names[2 * s + 1], yuv)):
                    with open(os.path.join(kdir, name), "wb") as f:
                        f.write(png.encode(img))
            keep.append((fr, kdir))
        return check(ctx, frames, keep, digits, fisr_p, pwc_p)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check(ctx, frames, keep, digits, fisr_p, pwc_p):
    """The kept windows, up to `check_windows` drawn from the seed, against
    the float32 reference: the RMS of the u8 difference over every value of
    their RGB and YUV files. Returns (checks, files missing or unreadable)."""
    t0 = time.perf_counter()
    nets = reference_nets(ctx, fisr_p, pwc_p)
    order = ctx.rng(5).permutation(len(keep))[:ctx.mix["check_windows"]]
    sq = count = 0.0
    bad, saturated, file_bytes = 0, [], []
    for i in sorted(order):
        fr, kdir = keep[i]
        ref = reference_window(ctx, nets, frames, fr)
        names = _names(fr, digits)
        for s in (0, 1):
            yuv = ref[..., 3 * s:3 * s + 3]
            for name, want in ((names[2 * s], yuv2rgb_u8(yuv)), (names[2 * s + 1], yuv)):
                try:
                    with open(os.path.join(kdir, name), "rb") as fh:
                        data = fh.read()
                    got = png.decode(data)
                except (OSError, ValueError) as e:
                    print(f"video: {name} of window {fr}: {e}", file=sys.stderr)
                    bad += 1
                    continue
                if got.shape != want.shape:
                    print(f"video: {name} is {got.shape}, want {want.shape}", file=sys.stderr)
                    bad += 1
                    continue
                d = got.astype(np.float64) - want.astype(np.float64)
                sq += float(np.sum(d * d))
                count += d.size
                saturated.append(float(np.mean((got == 0) | (got == 255))))
                file_bytes.append(len(data))
    rms = float(np.sqrt(sq / count)) if count else float("inf")
    print(f"video: reference check {time.perf_counter() - t0:.1f} s; the checked files "
          f"(RGB, YUV of each frame): bytes {file_bytes}, share of values at 0 or 255 "
          f"{[round(x, 4) for x in saturated]}", file=sys.stderr)
    return [("rms_u8", rms, ctx.mix["limits"]["rms_u8"])], bad
