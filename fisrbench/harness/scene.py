"""Seeded synthetic inputs, made on the device in a few large calls.

`clip`: YUV video frames of a textured scene under a global pan, with
textured discs that move on their own, so that flows are neither zero nor
uniform. Every seed gets the same sizes, speeds and counts; the seed picks
the textures, directions and positions.

`flow_pairs`: FlyingChairs-sized training pairs: a textured image, a smooth
flow field (an affine motion plus low-frequency noise) and the second image
pulled back along it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fisrbench.reference.ops import rgb2yuv


def _octaves(gen, n, c, h, w, cells, amps, device):
    """[n, c, h, w] of smooth noise: bicubic-upsampled Gaussian grids."""
    out = torch.zeros((n, c, h, w), device=device)
    for cell, amp in zip(cells, amps):
        g = torch.randn((n, c, h // cell + 3, w // cell + 3), generator=gen, device=device)
        up = F.interpolate(g, scale_factor=cell, mode="bicubic", align_corners=False)
        out += amp * up[:, :, cell:cell + h, cell:cell + w]
    return out


def _colour(field):
    """[n, 3, h, w] noise -> RGB in [0, 255]: a luminance field and two
    weaker chroma fields."""
    lum, a, b = field[:, 0:1], 0.35 * field[:, 1:2], 0.35 * field[:, 2:3]
    rgb = torch.cat([lum + a, lum - 0.5 * a + b, lum - 0.5 * a - b], dim=1)
    return (127.5 + 60.0 * rgb).clamp(0.0, 255.0)


def _sample(img, x, y):
    """Bilinear samples of img [n, c, H, W] at pixel coordinates x, y [n, h, w]."""
    hh, ww = img.shape[2], img.shape[3]
    grid = torch.stack([(2 * x + 1) / ww - 1, (2 * y + 1) / hh - 1], dim=-1)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=False)


def clip(gen: torch.Generator, n: int, h: int, w: int, pan_px: float, objects: int,
         obj_radius: tuple, obj_px: tuple, device) -> torch.Tensor:
    """n YUV frames [n, h, w, 3] u8 on `device`."""
    rnd = lambda *s: torch.rand(s, generator=gen, device=device)  # noqa: E731
    ang = float(rnd(1)) * 2 * math.pi
    vx, vy = pan_px * math.cos(ang), pan_px * math.sin(ang)
    m = int(math.ceil(pan_px * (n - 1))) + 2
    ch, cw = h + 2 * m, w + 2 * m
    canvas = _colour(_octaves(gen, 1, 3, ch, cw, (96, 24, 6), (1.0, 0.5, 0.25), device))
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :].expand(h, w)
    t = torch.arange(n, device=device, dtype=torch.float32)[:, None, None]
    frames = _sample(canvas.expand(n, -1, -1, -1), xs + m + vx * t, ys + m + vy * t)
    r0, r1 = obj_radius
    s0, s1 = obj_px
    tex = _colour(_octaves(gen, objects, 3, 2 * r1 + 8, 2 * r1 + 8, (24, 6), (1.0, 0.5),
                           device))
    for k in range(objects):
        r = r0 + (r1 - r0) * float(rnd(1))
        sp = s0 + (s1 - s0) * float(rnd(1))
        a = float(rnd(1)) * 2 * math.pi
        cx0, cy0 = float(rnd(1)) * w, float(rnd(1)) * h
        cx = cx0 + sp * math.cos(a) * t
        cy = cy0 + sp * math.sin(a) * t
        dist = torch.sqrt((xs - cx) ** 2 + (ys - cy) ** 2)
        alpha = (r - dist).clamp(0.0, 1.0)[:, None]
        u = xs - cx + r1 + 4
        v = ys - cy + r1 + 4
        obj = _sample(tex[k:k + 1].expand(n, -1, -1, -1), u, v)
        frames = frames * (1 - alpha) + obj * alpha
    yuv = rgb2yuv(frames.permute(0, 2, 3, 1))
    return yuv.to(torch.uint8)


def flow_pairs(gen: torch.Generator, n: int, h: int, w: int, max_px: float, device,
               chunk: int = 64):
    """n training pairs: (pairs u8 [n, 2, h, w, 3], flows f32 [n, h, w, 2]) on
    `device`, with img1(q) = img2(q + flow(q))."""
    pairs = torch.empty((n, 2, h, w, 3), dtype=torch.uint8, device=device)
    flows = torch.empty((n, h, w, 2), dtype=torch.float32, device=device)
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :].expand(h, w)
    for i in range(0, n, chunk):
        k = min(chunk, n - i)
        img = _colour(_octaves(gen, k, 3, h, w, (64, 16, 4), (1.0, 0.5, 0.25), device))
        # affine motion about the centre plus smooth noise, |flow| within max_px
        p = (torch.rand((k, 6), generator=gen, device=device) * 2 - 1)
        xc, yc = (xs - w / 2) / w, (ys - h / 2) / h
        u = p[:, 0, None, None] * 0.5 + p[:, 1, None, None] * 0.25 * xc + p[:, 2, None, None] * 0.25 * yc
        v = p[:, 3, None, None] * 0.5 + p[:, 4, None, None] * 0.25 * xc + p[:, 5, None, None] * 0.25 * yc
        noise = _octaves(gen, k, 2, h, w, (128,), (0.25,), device)
        u = (u + noise[:, 0]) * max_px
        v = (v + noise[:, 1]) * max_px
        img2 = _sample(img, xs - u, ys - v)
        pairs[i:i + k, 0] = img.permute(0, 2, 3, 1).to(torch.uint8)
        pairs[i:i + k, 1] = img2.permute(0, 2, 3, 1).to(torch.uint8)
        flows[i:i + k] = torch.stack([u, v], dim=-1)
    return pairs, flows
