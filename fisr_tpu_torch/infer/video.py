"""FISR_for_video, fused path (port of fisr_tpu/infer/video.py): joint 2x
frame-rate + 2x resolution upscaling of a folder of YUV PNG frames, with
flow, middle-frame warps and FISRnet all on the device.

Per adjacent frame pair, once: YUV -> RGB, x2 bilinear upscale, bidirectional
PWC-Net flow in one batch of 2B, flow scaled back to the frame, and the two
+0.5-flow middle-frame warps. Per 3-frame window: the 29-channel input and
full-frame FISRnet. The JAX functions are jitted; here they are plain
callables that run eagerly without autograd.

Not ported yet (ROADMAP.md, Queue 1): the staged path (TiledRunner and the
.flo/.mat artifacts) and fisr_grid tiling of the window stage.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fisr_tpu_torch.data.png_io import list_pngs, read_png, write_png
from fisr_tpu_torch.device import resolve_device
from fisr_tpu_torch.models import fisrnet, pwcnet
from fisr_tpu_torch.ops.color import rgb2yuv_matlab, yuv2rgb_matlab, yuv2rgb_matlab_u8
from fisr_tpu_torch.ops.conv import F32, Policy
from fisr_tpu_torch.ops.resize import resize_tf1, upsample2x_bilinear
from fisr_tpu_torch.ops.warp import dense_image_warp

__all__ = ["make_flow_fn", "make_warp_fn", "make_pair_fn", "make_fisr_window_fn",
           "make_fused_video_step", "run_video_pipeline"]

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


def _fisr_window_core(model: fisrnet.FISRnet, f0, f1, f2, flows01, warps01,
                      flows12, warps12, policy: Policy, sf: int) -> torch.Tensor:
    """29-channel input assembly + full-frame FISRnet for one window."""
    img = (torch.cat([f0, f1, f2], dim=-1) / 255.0).clamp(0.0, 1.0)
    fl = torch.cat([flows01[:, 0], flows01[:, 1], flows12[:, 0], flows12[:, 1]], dim=-1)
    fl = (fl / FLOW_NORM).clamp(-1.0, 1.0)
    wp = torch.cat([warps01[:, 0], warps01[:, 1], warps12[:, 0], warps12[:, 1]], dim=-1)
    wp = (wp / 255.0).clamp(0.0, 1.0)
    inp = torch.cat([img, fl, wp], dim=-1)  # [B, h, w, 29]
    return fisrnet.apply(model, inp, sf, policy)[2].float().clamp(0.0, 1.0)


def make_fisr_window_fn(policy: Policy = F32, sf: int = 2):
    """fn(fisr_model, frames [B,3,h,w,3] YUV in [0,255], (flows01, warps01),
    (flows12, warps12)) -> [B, h*sf, w*sf, 9] in [0, 1]."""

    @torch.no_grad()
    def fn(model, frames, pair01, pair12):
        return _fisr_window_core(model, frames[:, 0], frames[:, 1], frames[:, 2],
                                 pair01[0], pair01[1], pair12[0], pair12[1], policy, sf)
    return fn


def make_fused_video_step(cfg: pwcnet.PWCNetConfig = pwcnet.PWCNetConfig(),
                          policy: Policy = F32, upscale: int = 2, sf: int = 2):
    """One full window, both pairs recomputed: fn(fisr_model, pwc_model,
    frames [B, 3, h, w, 3] YUV in [0, 255]) -> [B, h*sf, w*sf, 9] in [0, 1]
    ([fr1, SR, fr2]). h, w multiples of 32."""

    @torch.no_grad()
    def step(fisr_model, pwc_model, frames):
        f0, f1, f2 = frames[:, 0], frames[:, 1], frames[:, 2]
        flows01 = _flow_core(pwc_model, f0, f1, cfg, policy, upscale)
        flows12 = _flow_core(pwc_model, f1, f2, cfg, policy, upscale)
        return _fisr_window_core(fisr_model, f0, f1, f2, flows01, _warp_core(f0, f1, flows01),
                                 flows12, _warp_core(f1, f2, flows12), policy, sf)
    return step


def run_video_pipeline(fisr_model: fisrnet.FISRnet, pwc_model: pwcnet.PWCNet,
                       frame_folder: str, out_folder: Optional[str] = None,
                       policy: Policy = F32, frame_num: Optional[int] = None,
                       verbose: bool = True, fused: bool = False,
                       flow_upscale: int = 2, device="cuda"):
    """FISR_for_video over a folder of YUV PNGs; returns the RGB output paths.

    Each adjacent pair's flow and warps run once (make_pair_fn) and feed two
    windows (make_fisr_window_fn). Frames are cropped to multiples of 32.
    Outputs: pred_{i}.png (RGB) and pred_YUV_{i}.png, i = 0 .. 2(n-2), in
    out_folder (default <frame_folder>/FISR_frames). Both models are moved
    to `device`; PWC-Net runs under its own cfg.
    """
    if not fused:
        raise NotImplementedError(
            "the staged FISR_for_video path (TiledRunner, .flo/.mat artifacts) is "
            "not ported yet (ROADMAP.md, Queue 1); pass fused=True")
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

    frames = np.stack([read_png(p) for p in paths])  # YUV u8 [n, H, W, 3]
    h = frames.shape[1] - frames.shape[1] % 32
    w = frames.shape[2] - frames.shape[2] % 32
    pair_fn = make_pair_fn(pwc_model.cfg, policy, flow_upscale)
    window_fn = make_fisr_window_fn(policy)
    digits = math.ceil(math.log10(2 * (n - 1)))

    def upload(i):
        return torch.from_numpy(frames[None, i, :h, :w]).to(dev).float()

    out_paths, writes = [], []
    with ThreadPoolExecutor(max_workers=4) as pool:
        d0, d1 = upload(0), upload(1)
        prev_pair = pair_fn(pwc_model, d0, d1)
        for fr in range(n - 2):
            d2 = upload(fr + 2)
            new_pair = pair_fn(pwc_model, d1, d2)
            pred = window_fn(fisr_model, torch.stack([d0, d1, d2], dim=1), prev_pair, new_pair)
            pred_u8 = (pred[0] * 255).to(torch.uint8).cpu().numpy()
            d0, d1, prev_pair = d1, d2, new_pair
            for s in range(3):
                idx = str(fr * 2 + s).zfill(digits)
                yuv = pred_u8[:, :, 3 * s:3 * s + 3]
                p_rgb = os.path.join(out_folder, f"pred_{idx}.png")
                p_yuv = os.path.join(out_folder, f"pred_YUV_{idx}.png")
                writes.append(pool.submit(write_png, yuv2rgb_matlab_u8(yuv), p_rgb))
                writes.append(pool.submit(write_png, yuv, p_yuv))
                out_paths.append(p_rgb)
            if verbose:
                print(f"<FISR fused> window [{fr + 1}/{n - 2}]", flush=True)
        for fut in writes:
            fut.result()
    return out_paths
