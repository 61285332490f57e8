"""Halo-sharded multi-device inference (port of fisr_tpu/infer/sharded.py).

One frame split along its width over the mesh's 'spatial' axis: each rank
takes its strip, swaps `boundary`-pixel halo strips with its neighbours
(core/mesh.ppermute, point-to-point), runs FISRnet on its extended strip and
trims the halo; the output comes back as each rank's strip of the canvas.

The two ends of the frame take zero halos (JAX masks the strips its ring
wraps around; here the shifts do not wrap, and a rank that no neighbour
sends to receives zeros, as from `ppermute`), so the result equals the
zero-padded tiling with a (1, n) grid, `TiledRunner(mode='padded')`, for
n > 1. With n = 1 both halos are zeros and the strip is the whole frame,
zero-padded by `boundary` on both sides (a (1, 1) tiling pads nothing).
"""

from __future__ import annotations

import torch

from fisr_tpu_torch.core.mesh import (SPATIAL_AXIS, axis_sharding, axis_size, mesh_device,
                                      ppermute)
from fisr_tpu_torch.models import fisrnet
from fisr_tpu_torch.ops.conv import F32, Policy

__all__ = ["make_sharded_runner"]


def make_sharded_runner(mesh, axis: str = SPATIAL_AXIS, boundary: int = 32, sf: int = 2,
                        policy: Policy = F32):
    """fn(model, inp [B, h, w, 29]) -> this rank's strip [B, h*sf, w*sf/n, 9]
    (f32), where n is the size of `axis` and `w` divides by n * 32. `inp` is
    the whole frame (numpy or a tensor on any device); each rank cuts its
    strip and moves it to its device, where `model` must be.
    core/mesh.all_gather_axis(out, mesh, axis, dim=2) gives the whole
    canvas."""
    n = axis_size(mesh, axis)
    to_right = [(i, i + 1) for i in range(n - 1)]  # my right edge -> right neighbour
    to_left = [(i + 1, i) for i in range(n - 1)]
    strip_of = axis_sharding(mesh, axis, dim=2, ndim=4)
    dev = mesh_device(mesh)

    @torch.no_grad()
    def fn(model, inp):
        w = inp.shape[2]
        if w % (n * 32):
            raise ValueError(f"width {w} must divide by {n} strips x 32")
        x = torch.as_tensor(strip_of(inp)).to(dev)
        # halo from my left neighbour = its rightmost columns, and vice versa
        from_left = ppermute(x[:, :, -boundary:], mesh, axis, to_right)
        from_right = ppermute(x[:, :, :boundary], mesh, axis, to_left)
        x_ext = torch.cat([from_left, x, from_right], dim=2)
        pred = fisrnet.apply(model, x_ext, sf, policy)[2]
        t = boundary * sf
        return pred[:, :, t:pred.shape[2] - t, :].float()

    return fn
