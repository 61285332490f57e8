"""Partial cost volume (PWC-Net local correlation), the plain PyTorch version
(port of fisr_tpu/ops/cost_volume.py).

    cost[b, y, x, (dy+d)*(2d+1)+(dx+d)] = mean_c c1[b,y,x,c] * c2[b,y+dy,x+dx,c]

for |dy|, |dx| <= d; samples outside the frame count as zero.

This is what a CPU tensor runs (with autograd for its gradient) and what the
CUDA kernel (fisr_tpu_torch/kernels/cost_volume.py) is held against on the
card. It keeps the kernel's arithmetic: products and sums in f32, times 1/C in
f32, one cast to the input dtype at the end. `cost_volume_backward` is the
same for the backward kernel: the two input gradients written out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cost_volume", "cost_volume_backward"]


def cost_volume(c1: torch.Tensor, c2: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """c1, c2: [B, H, W, C] -> [B, H, W, (2*search_range+1)**2]."""
    b, h, w, c = c1.shape
    d = search_range
    n = 2 * d + 1
    a = c1.float()
    pad = F.pad(c2.float(), (0, 0, d, d, d, d))
    inv_c = 1.0 / c
    planes = [(a * pad[:, dy:dy + h, dx:dx + w, :]).sum(-1) * inv_c
              for dy in range(n) for dx in range(n)]
    return torch.stack(planes, dim=-1).to(c1.dtype)


def cost_volume_backward(c1: torch.Tensor, c2: torch.Tensor, g: torch.Tensor,
                         search_range: int = 4):
    """The gradients of `cost_volume` for the output gradient g [B, H, W,
    (2d+1)**2]:

        dc1[b,y,x,c] = (1/C) sum_k g[b,y,x,k] * c2[b,y+dy,x+dx,c]
        dc2[b,y,x,c] = (1/C) sum_k g[b,y-dy,x-dx,k] * c1[b,y-dy,x-dx,c]

    with k = (dy+d)*(2d+1)+(dx+d) and zeros outside the frame; sums in f32,
    g taken times 1/C first, as autograd of `cost_volume` takes it, and the
    sums in f32 in (dy, dx) order; one cast to each input's dtype. Returns
    (dc1, dc2)."""
    b, h, w, c = c1.shape
    d = search_range
    n = 2 * d + 1
    a = c1.float()
    gf = g.float() * (1.0 / c)
    pad = F.pad(c2.float(), (0, 0, d, d, d, d))
    dc1 = torch.zeros_like(a)
    dc2 = torch.zeros_like(pad)
    for dy in range(n):
        for dx in range(n):
            gk = gf[..., dy * n + dx, None]
            dc1 += gk * pad[:, dy:dy + h, dx:dx + w]
            dc2[:, dy:dy + h, dx:dx + w] += gk * a
    return dc1.to(c1.dtype), dc2[:, d:d + h, d:d + w].to(c2.dtype)
