"""Partial cost volume (PWC-Net local correlation), the plain PyTorch version
(port of fisr_tpu/ops/cost_volume.py).

    cost[b, y, x, (dy+d)*(2d+1)+(dx+d)] = mean_c c1[b,y,x,c] * c2[b,y+dy,x+dx,c]

for |dy|, |dx| <= d; samples outside the frame count as zero.

This is what a CPU tensor runs, what the CUDA kernel
(fisr_tpu_torch/kernels/cost_volume.py) is held against on the card, and
what its backward differentiates. It keeps the kernel's arithmetic: products
and sums in f32, times 1/C in f32, one cast to the input dtype at the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cost_volume"]


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
