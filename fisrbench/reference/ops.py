"""Plain operations of the frozen reference: convolutions, TF1-legacy resize,
dense warp, cost volume and the MATLAB colour transforms, all NHWC.

Written with plain torch operations only. Every convolution goes through
`Numerics.conv`, which counts its multiply-adds (for the benchmark's useful
FLOPs) and, for the controls, rounds its operands to a lower precision.
Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F


class Numerics:
    """How the reference computes: f32 with TF32 off (`exact`), or a control
    one precision below a configuration's: `tf32` (TF32 convolutions; on a
    device without TF32, the CPU, their operands rounded to TF32's 10-bit
    mantissa instead) or `fp8` (every convolution's and the cost volume's
    operands rounded to fp8 e4m3 under a per-tensor scale). Rounding passes
    gradients straight through. Run the reference inside `backend()`, which
    sets the TF32 flags to the mode.
    `macs` counts the multiply-adds of every convolution, transposed
    convolution and cost volume, by their shapes."""

    MODES = ("exact", "tf32", "fp8")

    def __init__(self, mode: str = "exact"):
        if mode not in self.MODES:
            raise ValueError(f"numerics {mode!r}, not one of {self.MODES}")
        self.mode = mode
        self.macs = 0

    @contextmanager
    def backend(self):
        """TF32 on for `tf32`, off otherwise, restored after."""
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield self
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "exact" or x.device.type == "meta":
            return x
        if self.mode == "tf32":
            if x.device.type == "cuda":
                return x  # the backend flag
            i = x.detach().float().view(torch.int32)
            low = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1) + 4095
            r = torch.bitwise_and(i + low, ~0x1FFF).view(torch.float32).to(x.dtype)
        else:
            amax = x.detach().abs().amax().float().clamp(min=1e-30)
            scale = 448.0 / amax
            r = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
        return x + (r - x).detach()

    def conv(self, x, w, b, stride=1, dilation=1):
        """TF SAME conv + bias, NHWC in and out."""
        v = x.permute(0, 3, 1, 2)
        k = w.shape[-1]
        ph = _same_pads(v.shape[2], k, stride, dilation)
        pw = _same_pads(v.shape[3], k, stride, dilation)
        v = F.pad(v, (pw[0], pw[1], ph[0], ph[1]))
        out = F.conv2d(self.q(v), self.q(w), b, stride, 0, dilation)
        self.macs += out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return out.permute(0, 2, 3, 1)

    def deconv(self, x, w, b):
        """tf.nn.conv2d_transpose 4x4 stride 2 SAME; w is [c_in, c_out, 4, 4]."""
        out = F.conv_transpose2d(self.q(x.permute(0, 3, 1, 2)), self.q(w), b, stride=2,
                                 padding=1)
        self.macs += x.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return out.permute(0, 2, 3, 1)

    def cost_volume(self, c1, c2, d: int = 4):
        """cost[b, y, x, (dy+d)(2d+1)+(dx+d)] = mean_c c1[y, x] c2[y+dy, x+dx],
        zeros outside the frame."""
        b, h, w, c = c1.shape
        n = 2 * d + 1
        a = self.q(c1)
        pad = F.pad(self.q(c2), (0, 0, d, d, d, d))
        planes = [(a * pad[:, dy:dy + h, dx:dx + w, :]).mean(-1)
                  for dy in range(n) for dx in range(n)]
        self.macs += b * h * w * c * n * n
        return torch.stack(planes, dim=-1)


def _same_pads(n: int, k: int, stride: int, dilation: int):
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def leaky(x):
    return F.leaky_relu(x, 0.1)


# ---- TF1 legacy resize (in = out * in_size / out_size, no half-pixel) ----

def _up_axis(v, axis):
    n = v.shape[axis]
    nxt = torch.cat([v.narrow(axis, 1, n - 1), v.narrow(axis, n - 1, 1)], dim=axis)
    half = (v + nxt) * 0.5
    shape = list(v.shape)
    shape[axis] *= 2
    return torch.stack([v, half], dim=axis + 1).reshape(shape)


def upsample2x(x):
    """out[2i] = in[i], out[2i+1] = (in[i] + in[i+1]) / 2, the last reading in[i] twice."""
    return _up_axis(_up_axis(x, x.ndim - 3), x.ndim - 2)


def _resize_axis(x, out_size, axis):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if in_size % out_size == 0:  # an integer downscale is subsampling
        idx = torch.arange(0, in_size, in_size // out_size, device=x.device)
        return x.index_select(axis, idx)
    coords = np.arange(out_size, dtype=np.float64) * (in_size / out_size)
    base = np.floor(coords).astype(np.int64)
    frac = torch.from_numpy((coords - base).astype(np.float32)).to(x.device, x.dtype)
    i0 = torch.from_numpy(np.clip(base, 0, in_size - 1)).to(x.device)
    i1 = torch.from_numpy(np.clip(base + 1, 0, in_size - 1)).to(x.device)
    shape = [1] * x.ndim
    shape[axis] = out_size
    frac = frac.reshape(shape)
    return x.index_select(axis, i0) * (1 - frac) + x.index_select(axis, i1) * frac


def resize_bilinear(x, size):
    """TF1 `resize_images(..., BILINEAR)` with align_corners=False, NHWC."""
    h, w = x.shape[-3], x.shape[-2]
    if size[0] == 2 * h and size[1] == 2 * w:
        return upsample2x(x)
    return _resize_axis(_resize_axis(x, size[0], x.ndim - 3), size[1], x.ndim - 2)


# ---- warp ----

def warp(img, flow):
    """out[b, y, x] = img[b, y + v, x + u], bilinear, coordinates clamped to
    the frame; flow[..., 0] = u (horizontal)."""
    b, h, w, c = img.shape
    gx = torch.arange(w, dtype=torch.float32, device=img.device)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=img.device)[None, :, None]
    qx = (gx + flow[..., 0].float()).clamp(0.0, w - 1.0)
    qy = (gy + flow[..., 1].float()).clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(qx), torch.floor(qy)
    fx, fy = (qx - x0)[..., None], (qy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = (x0i + 1).clamp(max=w - 1), (y0i + 1).clamp(max=h - 1)
    flat = img.reshape(b, h * w, c)
    rows = torch.arange(b, device=img.device)[:, None]

    def at(yi, xi):
        return flat[rows, (yi * w + xi).reshape(b, h * w)].reshape(b, h, w, c)

    top = at(y0i, x0i) * (1 - fx) + at(y0i, x1i) * fx
    bot = at(y1i, x0i) * (1 - fx) + at(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


# ---- colour (MATLAB ycbcr2rgb / rgb2ycbcr, [0, 255]) ----

_TINV = np.array([[0.00456621, 0.0, 0.00625893],
                  [0.00456621, -0.00153632, -0.00318811],
                  [0.00456621, 0.00791071, 0.0]], np.float64)
_OFFSET = np.array([16.0, 128.0, 128.0], np.float64)
M_YUV2RGB = (255.0 * _TINV).astype(np.float32)
B_YUV2RGB = (255.0 * _TINV @ _OFFSET).astype(np.float32)
_T_FWD = np.array([[65.481, 128.553, 24.966],
                   [-37.797, -74.203, 112.0],
                   [112.0, -93.786, -18.214]], np.float64)
M_RGB2YUV = (_T_FWD / 255.0).astype(np.float32)
B_RGB2YUV = _OFFSET.astype(np.float32)


def _affine3(x, m, b, sign):
    x = x.float()
    out = [float(m[r, 0]) * x[..., 0] + float(m[r, 1]) * x[..., 1] + float(m[r, 2]) * x[..., 2]
           + float(np.float32(sign * b[r])) for r in range(3)]
    return torch.stack(out, dim=-1)


def yuv2rgb(yuv):
    return _affine3(yuv, M_YUV2RGB, B_YUV2RGB, -1.0).clamp(0.0, 255.0)


def rgb2yuv(rgb):
    return _affine3(rgb, M_RGB2YUV, B_RGB2YUV, 1.0).clamp(0.0, 255.0)


def yuv2rgb_u8(yuv_u8: np.ndarray) -> np.ndarray:
    """Host u8 YUV -> u8 RGB: the f32 constants widened to double, summed in
    channel order, clipped and truncated."""
    x = yuv_u8.astype(np.float64)
    m, b = M_YUV2RGB.astype(np.float64), -B_YUV2RGB.astype(np.float64)
    out = [x[..., 0] * m[r, 0] + x[..., 1] * m[r, 1] + x[..., 2] * m[r, 2] + b[r]
           for r in range(3)]
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


def glorot_std(shape) -> float:
    """Glorot-normal std of a [A, B, k, k] kernel (conv OIHW or transposed IOHW)."""
    return math.sqrt(2.0 / (shape[2] * shape[3] * (shape[0] + shape[1])))
