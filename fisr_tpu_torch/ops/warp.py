"""Dense bilinear backward warp (port of fisr_tpu/ops/warp.py).

out[b, y, x] = img[b, y + v, x + u], bilinear, with the sample coordinates
clamped to the frame (replicate border, the cv2.remap BORDER_REPLICATE of the
reference's middle-frame synthesis). `flow[..., 0]` is u (horizontal),
channel 1 is v. Differentiable in image and flow.

The JAX package has two exact formulations chosen by size for the TPU
(`taps`, `patch`); this is the per-tap one, four row gathers on the
flattened [H*W, C] plane. `grid_sample` is not used: its border mode clamps
the same way, but it recomputes the coordinates from a normalised grid and
rounds differently.
"""

from __future__ import annotations

import torch

__all__ = ["dense_image_warp"]


def dense_image_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C], flow [B, H, W, 2] (u, v) -> [B, H, W, C]."""
    b, h, w, c = img.shape
    dtype, dev = img.dtype, img.device
    # coordinates in f32 whatever the compute dtype (f64 for an f64 flow, as
    # a gradient check passes it)
    ct = torch.promote_types(flow.dtype, torch.float32)
    gx = torch.arange(w, dtype=ct, device=dev)[None, None, :]
    gy = torch.arange(h, dtype=ct, device=dev)[None, :, None]
    qx = (gx + flow[..., 0].to(ct)).clamp(0.0, w - 1.0)
    qy = (gy + flow[..., 1].to(ct)).clamp(0.0, h - 1.0)
    x0 = torch.floor(qx)
    y0 = torch.floor(qy)
    fx = (qx - x0).to(dtype)[..., None]
    fy = (qy - y0).to(dtype)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)

    flat = img.reshape(b, h * w, c)
    rows = torch.arange(b, device=dev)[:, None]

    def gather(yi, xi):
        return flat[rows, (yi * w + xi).reshape(b, h * w)].reshape(b, h, w, c)

    top = gather(y0i, x0i) * (1 - fx) + gather(y0i, x1i) * fx
    bot = gather(y1i, x0i) * (1 - fx) + gather(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy
