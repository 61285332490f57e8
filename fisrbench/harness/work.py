"""The yardstick's arithmetic: the card's published peaks, the cost volume's
least time from its shapes, and a model's useful FLOPs from a walk of the
frozen plain reference on the meta device.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, without sparsity),
at the full 700 W power limit. The cost-volume bounds count each input byte
read once and each output byte written once, or 2 * (2d+1)^2 * C operations
a pixel (forward) and 4 * (2d+1)^2 * C (backward, both input gradients),
whichever takes longer.
"""

from __future__ import annotations

import torch

from fisrbench.reference.fisrnet import FISRnetRef
from fisrbench.reference.fisrnet import param_shapes as fisr_shapes
from fisrbench.reference.ops import Numerics
from fisrbench.reference.pwcnet import PWCNetRef
from fisrbench.reference.pwcnet import param_shapes as pwc_shapes

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
ITEM = {"float32": 4, "bfloat16": 2}


def cv_bound_s(shape, dtype: str, d: int = 4) -> float:
    """Least time of one forward cost volume over [B, H, W, C] inputs."""
    b, h, w, c = shape
    nn = (2 * d + 1) ** 2
    nbytes = (2 * b * h * w * c + b * h * w * nn) * ITEM[dtype]
    flops = 2 * nn * c * b * h * w
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def cv_bwd_bound_s(shape, dtype: str, d: int = 4) -> float:
    """Least time of one backward: g, c1, c2 read once, dc1, dc2 written once."""
    b, h, w, c = shape
    nn = (2 * d + 1) ** 2
    nbytes = b * h * w * (nn + 4 * c) * ITEM[dtype]
    flops = 4 * nn * c * b * h * w
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def pwc_level_shapes(batch: int, h: int, w: int, cfg: dict):
    """[B, H, W, C] of the cost volume's inputs at levels top..bottom for
    an input of h x w (multiples of 2**top)."""
    from fisrbench.reference.pwcnet import PYR

    return [(batch, h >> lvl, w >> lvl, PYR[lvl])
            for lvl in range(cfg["pyr_lvls"], cfg["flow_pred_lvl"] - 1, -1)]


def _meta_params(shapes: dict) -> dict:
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


def pwc_flops(batch: int, h: int, w: int, cfg: dict, directions: int = 1) -> float:
    """Useful FLOPs of PWC-Net on `batch` image pairs of h x w: the pyramid
    of both images once, and `directions` flow estimations (2 for forward
    and backward flow from the same pyramids)."""
    nx = Numerics()
    net = PWCNetRef(_meta_params(pwc_shapes(**cfg)), numerics=nx, **cfg)
    x = torch.empty((batch, h, w, 3), device="meta")
    f1, f2 = net.features(x), net.features(x)
    for _ in range(directions):
        net.flows(f1, f2)
    return 2.0 * nx.macs


def fisr_flops(batch: int, h: int, w: int, cfg: dict) -> float:
    """Useful FLOPs of one full-frame FISRnet forward on [batch, h, w, in_ch]."""
    nx = Numerics()
    net = FISRnetRef(_meta_params(fisr_shapes(cfg["in_ch"], cfg["ch"], cfg["sf"])),
                     cfg["sf"], nx)
    net(torch.empty((batch, h, w, cfg["in_ch"]), device="meta"))
    return 2.0 * nx.macs
