"""FISR_for_video (port of fisr_tpu/infer/video.py): joint 2x frame-rate +
2x resolution upscaling of a folder of YUV PNG frames: flow, middle-frame
warps and FISRnet.

Per adjacent frame pair, once: YUV -> RGB, x2 bilinear upscale, bidirectional
PWC-Net flow in one batch of 2B, flow scaled back to the frame, and the two
+0.5-flow middle-frame warps. Per 3-frame window: the 29-channel input and
FISRnet. The JAX functions are jitted; here they are plain callables that
run eagerly without autograd.

Two paths, as in the reference (main.py:207-235 runs three programs that
hand over through files):
* fused: everything stays on the device; the window stage runs full-frame or
  through the device tiling of infer/device.py (`fisr_grid`);
* staged: flows and warps come back to the host (and, with
  `write_artifacts`, go to the reference's .flo / .mat files), windows are
  assembled on the host and run through infer/tiled.TiledRunner (`grid`,
  `boundary`: the reference's --test_patch tiling).
"""

from __future__ import annotations

import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fisr_tpu_torch.data import flo as flo_io
from fisr_tpu_torch.data import matio
from fisr_tpu_torch.data.png_io import list_pngs
from fisr_tpu_torch.device import resolve_device
from fisr_tpu_torch.infer.autotune import TuneCache, dtype_name
from fisr_tpu_torch.infer.device import best_grid, padded_grid, tiled_apply_padded
from fisr_tpu_torch.infer.tiled import TiledRunner
from fisr_tpu_torch.models import fisrnet, pwcnet
from fisr_tpu_torch.native import decode_png_batch, encode_png_bytes, yuv2rgb_ops_u8
from fisr_tpu_torch.ops.color import rgb2yuv_matlab, yuv2rgb_matlab
from fisr_tpu_torch.ops.conv import F32, Policy
from fisr_tpu_torch.ops.resize import resize_tf1, upsample2x_bilinear
from fisr_tpu_torch.ops.warp import dense_image_warp
from fisr_tpu_torch.utils import profiling

__all__ = ["make_flow_fn", "make_warp_fn", "make_pair_fn", "make_fisr_window_fn",
           "make_fused_video_step", "resolve_fisr_grid", "resolve_fisr_plan",
           "run_video_pipeline"]

FLOW_NORM = 96.0 * 2.0  # reference FISRnet.py:1016


def _pad_to(x: torch.Tensor, mult: int):
    """Zero-pad H, W up to multiples of `mult` (reference adapt_x)."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = (-h) % mult, (-w) % mult
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    return x, (h, w)


def _flow_core(model: pwcnet.PWCNet, yuv1, yuv2, cfg: pwcnet.PWCNetConfig,
               policy: Policy, upscale: int) -> torch.Tensor:
    """Bidirectional flow for a YUV pair -> [B, 2, h, w, 2] (fwd, bwd)."""
    rgb = [yuv2rgb_matlab(y) / 255.0 for y in (yuv1, yuv2)]
    h, w = rgb[0].shape[1], rgb[0].shape[2]
    if upscale == 2:
        rgb = [upsample2x_bilinear(r) for r in rgb]
    elif upscale != 1:
        rgb = [resize_tf1(r, (h * upscale, w * upscale), "bilinear") for r in rgb]
    pair0, (hh, ww) = _pad_to(rgb[0], 2**cfg.pyr_lvls)
    pair1, _ = _pad_to(rgb[1], 2**cfg.pyr_lvls)
    # both directions in one batch of 2B: the pyramid is extracted once, and
    # the backward direction's (c2, c1) is the batch halves swapped
    b = pair0.shape[0]
    c = pwcnet.extract_features(model, torch.cat([pair0, pair1]), cfg, policy)
    c_rev = [None] + [torch.cat([t[b:], t[:b]]) for t in c[1:]]
    flows2, _ = pwcnet.apply_pyramids(model, c, c_rev, cfg, policy)
    flows = torch.stack([flows2[:b, :hh, :ww], flows2[b:, :hh, :ww]], dim=1)
    return resize_tf1(flows, (h, w), "bilinear") / float(upscale)


def _warp_core(yuv1, yuv2, flows) -> torch.Tensor:
    """Middle frames [B, 2, h, w, 3] YUV: frame 2 pulled back and frame 1
    pulled forward by half their flows, in RGB."""
    mid1 = dense_image_warp(yuv2rgb_matlab(yuv2), flows[:, 0] * 0.5)
    mid2 = dense_image_warp(yuv2rgb_matlab(yuv1), flows[:, 1] * 0.5)
    return torch.stack([rgb2yuv_matlab(mid1), rgb2yuv_matlab(mid2)], dim=1)


def make_flow_fn(cfg: pwcnet.PWCNetConfig = pwcnet.PWCNetConfig(),
                 policy: Policy = F32, upscale: int = 2):
    """fn(pwc_model, yuv1, yuv2 [B,h,w,3] in [0,255]) -> flows [B,2,h,w,2]."""

    @torch.no_grad()
    def fn(model, yuv1, yuv2):
        return _flow_core(model, yuv1, yuv2, cfg, policy, upscale)
    return fn


def make_warp_fn():
    """fn(yuv1, yuv2, flows) -> warped YUV [B, 2, h, w, 3] in [0, 255]."""
    return torch.no_grad()(_warp_core)


def make_pair_fn(cfg: pwcnet.PWCNetConfig = pwcnet.PWCNetConfig(),
                 policy: Policy = F32, upscale: int = 2):
    """Everything an adjacent frame pair contributes, computed once:
    fn(pwc_model, yuv1, yuv2) -> (flows [B,2,h,w,2], warps [B,2,h,w,3])."""

    @torch.no_grad()
    def fn(model, yuv1, yuv2):
        flows = _flow_core(model, yuv1, yuv2, cfg, policy, upscale)
        return flows, _warp_core(yuv1, yuv2, flows)
    return fn


def resolve_fisr_plan(fisr_grid, h: int, w: int, policy: Policy, device="cuda"):
    """A fisr_grid spec as a concrete ((gh, gw), (pad_h, pad_w)).

    'auto'  -> infer/device.padded_grid (target (4, 6); pads an axis by up to
               10 % when that unlocks the target, e.g. 1056 rows -> (4, 6)
               with 96 pad rows);
    'tuned' -> the autotune cache's winner for `device`'s kind
               (infer/autotune, `python -m fisr_tpu_torch.cli.tune`), or
               'auto' where this frame size was never tuned there;
    tuple   -> passed through, pad 0.
    """
    if fisr_grid == "auto":
        return padded_grid(h, w)
    if fisr_grid == "tuned":
        plan = TuneCache(device=device).best_plan(h, w, dtype_name(policy))
        return plan or padded_grid(h, w)
    return tuple(fisr_grid), (0, 0)


def resolve_fisr_grid(fisr_grid, h: int, w: int, policy: Policy, device="cuda"):
    """Like `resolve_fisr_plan` but restricted to plans without padding:
    'auto' is infer/device.best_grid, 'tuned' the cache's best pad-free
    entry; the grid always divides (h, w)."""
    if fisr_grid == "auto":
        return best_grid(h, w)
    if fisr_grid == "tuned":
        return TuneCache(device=device).best(h, w, dtype_name(policy)) or best_grid(h, w)
    return tuple(fisr_grid)


def _fisr_window_core(model: fisrnet.FISRnet, f0, f1, f2, flows01, warps01,
                      flows12, warps12, policy: Policy, sf: int, fisr_grid=None,
                      clip_output: bool = True) -> torch.Tensor:
    """29-channel input assembly + the FISRnet stage for one window.

    fisr_grid None runs the whole frame; anything else goes through
    resolve_fisr_plan on the frames' device ('tuned' reads the cache at each
    call) and the device tiling. clip_output=False returns the prediction
    before its clip to [0, 1] (a training loss wants gradients that do not
    saturate); the serving paths keep the clip.
    """
    h, w = f0.shape[1], f0.shape[2]
    img = (torch.cat([f0, f1, f2], dim=-1) / 255.0).clamp(0.0, 1.0)
    fl = torch.cat([flows01[:, 0], flows01[:, 1], flows12[:, 0], flows12[:, 1]], dim=-1)
    fl = (fl / FLOW_NORM).clamp(-1.0, 1.0)
    wp = torch.cat([warps01[:, 0], warps01[:, 1], warps12[:, 0], warps12[:, 1]], dim=-1)
    wp = (wp / 255.0).clamp(0.0, 1.0)
    inp = torch.cat([img, fl, wp], dim=-1)  # [B, h, w, 29]
    if fisr_grid is not None:
        grid, pads = resolve_fisr_plan(fisr_grid, h, w, policy, device=f0.device)
        pred = tiled_apply_padded(model, inp, grid, pads, 32, sf, policy)
    else:
        pred = fisrnet.apply(model, inp, sf, policy)[2]
    pred = pred.float()
    return pred.clamp(0.0, 1.0) if clip_output else pred


def make_fisr_window_fn(policy: Policy = F32, sf: int = 2, fisr_grid=None):
    """fn(fisr_model, frames [B,3,h,w,3] YUV in [0,255], (flows01, warps01),
    (flows12, warps12)) -> [B, h*sf, w*sf, 9] in [0, 1]."""

    @torch.no_grad()
    def fn(model, frames, pair01, pair12):
        return _fisr_window_core(model, frames[:, 0], frames[:, 1], frames[:, 2],
                                 pair01[0], pair01[1], pair12[0], pair12[1], policy, sf,
                                 fisr_grid)
    return fn


def make_fused_video_step(cfg: pwcnet.PWCNetConfig = pwcnet.PWCNetConfig(),
                          policy: Policy = F32, upscale: int = 2, sf: int = 2,
                          fisr_grid=None):
    """One full window, both pairs recomputed: fn(fisr_model, pwc_model,
    frames [B, 3, h, w, 3] YUV in [0, 255]) -> [B, h*sf, w*sf, 9] in [0, 1]
    ([fr1, SR, fr2]). h, w multiples of 32. fisr_grid as in
    make_fisr_window_fn."""

    @torch.no_grad()
    def step(fisr_model, pwc_model, frames):
        f0, f1, f2 = frames[:, 0], frames[:, 1], frames[:, 2]
        flows01 = _flow_core(pwc_model, f0, f1, cfg, policy, upscale)
        flows12 = _flow_core(pwc_model, f1, f2, cfg, policy, upscale)
        return _fisr_window_core(fisr_model, f0, f1, f2, flows01, _warp_core(f0, f1, flows01),
                                 flows12, _warp_core(f1, f2, flows12), policy, sf, fisr_grid)
    return step


def _start_download(t: torch.Tensor):
    """Queue the copy of `t` to the host behind the work that produced it.
    Returns (host tensor, event or None). On a CUDA device the copy goes into
    pinned memory without blocking, so the caller can dispatch more work and
    wait for the event alone; a CPU tensor is returned as it is."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def run_video_pipeline(fisr_model: fisrnet.FISRnet, pwc_model: pwcnet.PWCNet,
                       frame_folder: str, out_folder: Optional[str] = None,
                       grid: Tuple[int, int] = (2, 2), boundary: int = 32,
                       policy: Policy = F32, write_artifacts: bool = False,
                       frame_num: Optional[int] = None, verbose: bool = True,
                       fused: bool = False, flow_upscale: int = 2, fisr_grid=None,
                       device="cuda"):
    """FISR_for_video over a folder of YUV PNGs; returns the RGB output paths.

    Outputs: pred_{i}.png (RGB) and pred_YUV_{i}.png, i = 0 .. 2(n-2), in
    out_folder (default <frame_folder>/FISR_frames). Both models are moved
    to `device`; PWC-Net runs under its own cfg.

    fused=True keeps flow, warps and FISRnet on the device. Each adjacent
    pair runs once (make_pair_fn) and feeds two windows
    (make_fisr_window_fn); frames are cropped to multiples of 32. The loop is
    one window deep: window k+1 is dispatched before window k's prediction
    is waited for, so the device works while the host converts colours and
    queues the PNG writes; values and file order are those of the plain
    loop. fisr_grid picks the window stage's tiling plan (None = full frame,
    the reference's video phase; 'auto' = infer/device.padded_grid; 'tuned' =
    the autotune cache's plan for `device`; a tuple). Tiling deviates from full-frame
    through the truncation of the receptive field at the 32-px halo.

    fused=False is the staged path: flows and warps of every pair come to
    the host, windows are assembled there and run through
    TiledRunner(grid, boundary, mode='exact'), the reference's --test_patch
    tiling; frames are cropped to multiples of 32*grid. With write_artifacts
    the reference-format <scene>_test_ss1_fr<n>.flo and
    <scene>_ss1_fr<n>_warp.mat go into the frame folder.

    flow_upscale=2 is the reference's trick (frames upscaled x2 before
    PWC-Net, the flow scaled back); 1 runs the flow at native resolution.
    """
    dev = resolve_device(device)
    fisr_model.to(dev)
    pwc_model.to(dev)
    paths = list_pngs(frame_folder)
    if frame_num is not None:
        paths = paths[:frame_num]
    n = len(paths)
    if n < 3:
        raise ValueError("need at least 3 frames")
    out_folder = out_folder or os.path.join(frame_folder, "FISR_frames")
    os.makedirs(out_folder, exist_ok=True)

    with profiling.span("video.decode"):
        frames = decode_png_batch(paths)  # YUV u8 [n, H, W, 3], decoded on threads
    digits = math.ceil(math.log10(2 * (n - 1)))
    out_paths, writes = [], []

    with ThreadPoolExecutor(max_workers=4) as pool:
        def emit(fr, pred_u8):
            """Queue the PNG writes of window `fr`: RGB and YUV for its output
            frames, numbered at twice the frame rate, each job converting
            (RGB), encoding and writing on a worker thread. A window's third
            frame has the number of the next window's first, which replaces
            it (as in the reference's loop, where the later write wins), so
            only the last window writes its third: every file is written
            once, and no two writer threads meet on one path."""
            for s in range(3):
                idx = str(fr * 2 + s).zfill(digits)
                yuv = pred_u8[:, :, 3 * s:3 * s + 3]
                p_rgb = os.path.join(out_folder, f"pred_{idx}.png")
                out_paths.append(p_rgb)
                if s == 2 and fr != n - 3:
                    continue
                p_yuv = os.path.join(out_folder, f"pred_YUV_{idx}.png")
                writes.append(pool.submit(_write_frame, yuv, p_rgb, True))
                writes.append(pool.submit(_write_frame, yuv, p_yuv, False))

        if fused:
            _fused_windows(fisr_model, pwc_model, frames, emit, policy, flow_upscale,
                           fisr_grid, dev, verbose)
        else:
            _staged_windows(fisr_model, pwc_model, frames, emit, frame_folder, grid, boundary,
                            policy, write_artifacts, flow_upscale, dev, verbose)
        with profiling.span("video.flush"):
            for fut in writes:
                fut.result()
    return out_paths


def _write_frame(yuv: np.ndarray, path: str, rgb: bool) -> None:
    """One output PNG of a YUV u8 frame, as RGB (ops/color's constants) or as
    it is: the host runtime's colour and threaded encoder, then the file.
    Timed in the `video.colour` and `video.encode` spans; each RGB file
    written counts one `video.frames`."""
    if rgb:
        with profiling.span("video.colour"):
            yuv = yuv2rgb_ops_u8(yuv)
    with profiling.span("video.encode"):
        png = encode_png_bytes(yuv)
    _write_file(png, path)
    if rgb:
        profiling.count("video.frames")


def _write_file(data: bytes, path: str) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _upload(frames: np.ndarray, i: int, h: int, w: int, dev) -> torch.Tensor:
    return torch.from_numpy(frames[None, i, :h, :w]).to(dev).float()


def _fused_windows(fisr_model, pwc_model, frames, emit, policy, flow_upscale, fisr_grid,
                   dev, verbose):
    """The pair-cached loop, one window deep: window k+1 is dispatched before
    window k's download is waited for."""
    n = frames.shape[0]
    h = frames.shape[1] - frames.shape[1] % 32
    w = frames.shape[2] - frames.shape[2] % 32
    pair_fn = make_pair_fn(pwc_model.cfg, policy, flow_upscale)
    window_fn = make_fisr_window_fn(policy, fisr_grid=fisr_grid)

    def drain(fr, host, done):
        if done is not None:
            done.synchronize()
        emit(fr, host.numpy())
        if verbose:
            print(f"<FISR fused> window [{fr + 1}/{n - 2}]", flush=True)

    pending = None
    d0, d1 = _upload(frames, 0, h, w, dev), _upload(frames, 1, h, w, dev)
    prev_pair = pair_fn(pwc_model, d0, d1)
    for fr in range(n - 2):
        d2 = _upload(frames, fr + 2, h, w, dev)
        new_pair = pair_fn(pwc_model, d1, d2)
        pred = window_fn(fisr_model, torch.stack([d0, d1, d2], dim=1), prev_pair, new_pair)
        host, done = _start_download((pred[0] * 255).to(torch.uint8))
        d0, d1, prev_pair = d1, d2, new_pair
        if pending is not None:
            drain(*pending)
        pending = (fr, host, done)
    drain(*pending)


def _staged_windows(fisr_model, pwc_model, frames, emit, frame_folder, grid, boundary, policy,
                    write_artifacts, flow_upscale, dev, verbose):
    """Flows and warps of every pair to the host (and to .flo / .mat), then
    host-assembled windows through TiledRunner (FISRnet.py:963-975)."""
    n, h0, w0 = frames.shape[:3]
    flow_fn = make_flow_fn(pwc_model.cfg, policy, flow_upscale)
    warp_fn = make_warp_fn()
    flows, warps = [], []
    for i in range(n - 1):
        y1, y2 = _upload(frames, i, h0, w0, dev), _upload(frames, i + 1, h0, w0, dev)
        fl = flow_fn(pwc_model, y1, y2)
        wp = warp_fn(y1, y2, fl)
        flows.append(fl[0].float().cpu().numpy())
        warps.append(wp[0].float().cpu().numpy())
        if verbose:
            print(f"flow+warp pair [{i + 1}/{n - 1}]", flush=True)
    flows = np.stack(flows)  # [n-1, 2, h, w, 2]
    warps = np.stack(warps)  # [n-1, 2, h, w, 3] YUV in [0, 255]

    if write_artifacts:
        scene = os.path.basename(os.path.normpath(frame_folder))
        flo_io.write_flo_5dim(flows, os.path.join(frame_folder, f"{scene}_test_ss1_fr{n}.flo"))
        matio.write_warp_mat(warps, os.path.join(frame_folder, f"{scene}_ss1_fr{n}_warp.mat"))

    runner = TiledRunner(fisr_model, grid=grid, boundary=boundary, policy=policy,
                         mode="exact", device=dev)
    h = h0 - h0 % (32 * grid[0])
    w = w0 - w0 % (32 * grid[1])
    frames_f = frames.astype(np.float32)
    flow_win = np.concatenate([flows[:n - 2], flows[1:n - 1]], axis=1)
    warp_win = np.concatenate([warps[:n - 2], warps[1:n - 1]], axis=1)
    t0 = time.time()
    for fr in range(n - 2):
        img = frames_f[fr:fr + 3, :h, :w].transpose(1, 2, 0, 3).reshape(h, w, 9)
        img = np.clip(img / 255.0, 0, 1)[None]
        fl = flow_win[fr][:, :h, :w].transpose(1, 2, 0, 3).reshape(h, w, 8)
        fl = np.clip(fl / FLOW_NORM, -1, 1)[None]
        wp = warp_win[fr][:, :h, :w].transpose(1, 2, 0, 3).reshape(h, w, 12)
        wp = np.clip(wp / 255.0, 0, 1)[None]
        inp = np.concatenate([img, fl, wp], axis=3).astype(np.float32)
        emit(fr, np.uint8(np.clip(runner(inp)[0], 0, 1) * 255))
        if verbose:
            print(f"<FISR> window [{fr + 1}/{n - 2}] ({(time.time() - t0) / 60:.2f} min)",
                  flush=True)
