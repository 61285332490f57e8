"""The reference's FISR_for_video window, in plain float32: per adjacent YUV
frame pair, bidirectional PWC-Net flow on the x2 bilinear upscaled RGB
frames, scaled back to the frame, and the two half-flow middle-frame warps;
per 3-frame window, the 29-channel FISRnet input and FISRnet, on the whole
frame or over a grid of patches with a 32-px ring (the service's plan).
The u8 output is the clipped prediction times 255, truncated or rounded."""

from __future__ import annotations

import torch

from fisrbench.reference.fisrnet import FISRnetRef
from fisrbench.reference.ops import resize_bilinear, rgb2yuv, upsample2x, warp, yuv2rgb
from fisrbench.reference.pwcnet import PWCNetRef

FLOW_NORM = 192.0  # 96 px at x2, the reference's FISRnet.py


def pair(pwc: PWCNetRef, yuv1, yuv2, upscale: int = 2):
    """YUV [1, h, w, 3] in [0, 255] -> (flows [1, 2, h, w, 2] (forward,
    backward), middle-frame warps [1, 2, h, w, 3] in YUV)."""
    h, w = yuv1.shape[1], yuv1.shape[2]
    rgb = []
    for y in (yuv1, yuv2):
        r = yuv2rgb(y) / 255.0
        rgb.append(upsample2x(r) if upscale == 2 else
                   resize_bilinear(r, (h * upscale, w * upscale)))
    m = 2 ** pwc.top
    hh, ww = rgb[0].shape[1], rgb[0].shape[2]
    ph, pw = (-hh) % m, (-ww) % m
    rgb = [torch.nn.functional.pad(r, (0, 0, 0, pw, 0, ph)) for r in rgb]
    f1, f2 = pwc.features(rgb[0]), pwc.features(rgb[1])
    fwd = pwc.flows(f1, f2)[0][:, :hh, :ww]
    bwd = pwc.flows(f2, f1)[0][:, :hh, :ww]
    flows = resize_bilinear(torch.stack([fwd, bwd], dim=1), (h, w)) / float(upscale)
    mid1 = warp(yuv2rgb(yuv2), flows[:, 0] * 0.5)
    mid2 = warp(yuv2rgb(yuv1), flows[:, 1] * 0.5)
    return flows, torch.stack([rgb2yuv(mid1), rgb2yuv(mid2)], dim=1)


def padded_plan(h: int, w: int, target=(4, 6), max_pad_frac: float = 0.10):
    """The 'auto' window plan: per axis the largest grid <= target whose
    32-px-multiple tiles need at most max_pad_frac of the extent as padding:
    ((gh, gw), (pad_h, pad_w))."""
    def axis(extent, tgt):
        for g in range(tgt, 0, -1):
            pad = (-extent) % (32 * g)
            if pad <= max_pad_frac * extent:
                return g, pad
        return 1, 0
    (gh, ph), (gw, pw) = axis(h, target[0]), axis(w, target[1])
    return (gh, gw), (ph, pw)


def tiled(fisr: FISRnetRef, x, grid, pads, boundary: int = 32):
    """FISRnet over a (gh, gw) patch grid: the frame edge-replicated at the
    bottom and right by `pads`, each split axis zero-padded by `boundary`,
    every patch with its ring through the whole model, the ring trimmed from
    each prediction and the cores put back together, cropped to the frame."""
    sf = fisr.sf
    b, h, w, _ = x.shape
    ph, pw = pads
    if ph or pw:
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                                    mode="replicate").permute(0, 2, 3, 1)
    gh, gw = grid
    hh, ww = x.shape[1], x.shape[2]
    sh, sw = hh // gh, ww // gw
    bh, bw = (boundary if gh > 1 else 0), (boundary if gw > 1 else 0)
    xp = torch.nn.functional.pad(x, (0, 0, bw, bw, bh, bh))
    out = torch.empty((b, hh * sf, ww * sf, 9), device=x.device, dtype=x.dtype)
    for i in range(gh):  # a row of patches at a time, batched
        row = torch.cat([xp[:, i * sh:(i + 1) * sh + 2 * bh, j * sw:(j + 1) * sw + 2 * bw]
                         for j in range(gw)])
        pred = fisr(row)
        for j in range(gw):
            out[:, i * sh * sf:(i + 1) * sh * sf, j * sw * sf:(j + 1) * sw * sf] = \
                pred[j * b:(j + 1) * b, bh * sf:(bh + sh) * sf, bw * sf:(bw + sw) * sf]
    return out[:, :h * sf, :w * sf]


def window_u8(fisr: FISRnetRef, pwc: PWCNetRef, f0, f1, f2, pair01=None, pair12=None,
              upscale: int = 2, rounding: str = "trunc", plan=None) -> torch.Tensor:
    """Three YUV frames [1, h, w, 3] -> u8 [2h, 2w, 9] ([interp1, SR, interp2]),
    the [0, 1] prediction times 255 truncated (the video writer) or rounded
    half to even (the HTTP service). `plan` ((gh, gw), pads) tiles FISRnet
    (`tiled`); None runs it on the whole frame."""
    fl01, wp01 = pair01 or pair(pwc, f0, f1, upscale)
    fl12, wp12 = pair12 or pair(pwc, f1, f2, upscale)
    img = (torch.cat([f0, f1, f2], dim=-1) / 255.0).clamp(0.0, 1.0)
    fl = torch.cat([fl01[:, 0], fl01[:, 1], fl12[:, 0], fl12[:, 1]], dim=-1)
    fl = (fl / FLOW_NORM).clamp(-1.0, 1.0)
    wp = torch.cat([wp01[:, 0], wp01[:, 1], wp12[:, 0], wp12[:, 1]], dim=-1)
    wp = (wp / 255.0).clamp(0.0, 1.0)
    inp = torch.cat([img, fl, wp], dim=-1)
    pred = (fisr(inp) if plan is None else tiled(fisr, inp, *plan)).clamp(0.0, 1.0)
    v = pred[0] * 255.0
    return (torch.round(v) if rounding == "round" else v).to(torch.uint8)
