"""Production serving: frame/window-parallel multi-device inference (port of
fisr_tpu/infer/serving.py).

Two complementary ways to scale FISR inference over a mesh:
* `infer/sharded.py`: ONE frame split spatially across devices (halo
  exchange): lowers the latency of a single frame;
* this module: many windows split across devices over the 'data' axis:
  raises throughput for video streams (windows are independent, so the
  devices exchange nothing but the shared frame pair below).

Each function takes the round's whole window batch, as the JAX callers pass
it (numpy or tensors on any device; N divisible by the axis size), cuts this
rank's contiguous rows, moves them to the rank's device, and returns this
rank's rows of the output (core/mesh.all_gather_axis gathers them). The
models must be on the rank's device.

`make_frame_parallel_stream_step` additionally shares each frame pair's
flow and warps between the two CONSECUTIVE windows that read it: the shared
pair comes from the left neighbour (core/mesh.ppermute) instead of being
recomputed, so a device's steady cost is 1 pair program + 1 window program
instead of 2 + 1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fisr_tpu_torch.core.mesh import (DATA_AXIS, axis_index, axis_size, broadcast_from,
                                      data_sharding, mesh_device, ppermute)
from fisr_tpu_torch.infer.device import make_device_runner
from fisr_tpu_torch.infer.video import (_fisr_window_core, _flow_core, _warp_core,
                                        make_fused_video_step)
from fisr_tpu_torch.models import pwcnet
from fisr_tpu_torch.ops.conv import F32, Policy

__all__ = ["make_frame_parallel_runner", "make_frame_parallel_video_step",
           "make_frame_parallel_stream_step", "pad_stream_round"]


def _local_rows(mesh, axis: str, x) -> torch.Tensor:
    """This rank's rows of a global batch, on the rank's device."""
    return torch.as_tensor(data_sharding(mesh, x.ndim, axis)(x)).to(mesh_device(mesh))


def make_frame_parallel_runner(mesh, mode: str = "tiled", grid: Tuple[int, int] = (2, 2),
                               boundary: int = 32, sf: int = 2, policy: Policy = F32,
                               axis: str = DATA_AXIS):
    """fn(model, windows [N, h, w, 29]) -> this rank's rows of
    [N, h*sf, w*sf, 9]: infer/device.make_device_runner on this rank's
    windows."""
    base = make_device_runner(mode, grid=grid, boundary=boundary, sf=sf, policy=policy)

    def fn(model, windows):
        return base(model, _local_rows(mesh, axis, windows))

    return fn


def make_frame_parallel_video_step(mesh, axis: str = DATA_AXIS, policy: Policy = F32, **kw):
    """The fused flow -> warp -> FISRnet step (video.make_fused_video_step,
    `kw` passed on) on this rank's windows: fn(fisr_model, pwc_model,
    frames [N, 3, h, w, 3]) -> this rank's rows of [N, h*sf, w*sf, 9]."""
    step = make_fused_video_step(policy=policy, **kw)

    def fn(fisr_model, pwc_model, frames):
        return step(fisr_model, pwc_model, _local_rows(mesh, axis, frames))

    return fn


def make_frame_parallel_stream_step(mesh, axis: str = DATA_AXIS, policy: Policy = F32,
                                    upscale: int = 2, sf: int = 2, fisr_grid=None, cfg=None,
                                    ragged: bool = False):
    """Pair-cached frame-parallel streaming: a round's consecutive windows in
    contiguous blocks over the axis, the shared frame pair passed on to the
    right neighbour instead of being recomputed.

    fn(fisr_model, pwc_model, frames [N, 3, h, w, 3] YUV in [0, 255],
       left_pair (flows [1, 2, h, w, 2], warps [1, 2, h, w, 3]))
      -> (this rank's rows of pred [N, h*sf, w*sf, 9] in [0, 1],
          last_pair, the globally last window's new pair, on every rank)
    where the N = n * B windows are consecutive (window k = frames (k, k+1,
    k+2)) and `left_pair` is pair (0, 1): seed it with video.make_pair_fn,
    then pass each round's `last_pair` in as the next round's `left_pair`.

    Each rank computes only its windows' new (second) pairs: both
    directions of all B pairs in one PWC-Net call (video._flow_core), then
    the warps. Its first window's first pair is its left neighbour's last
    new pair (ppermute one step right; rank 0 takes `left_pair`); its other
    windows take their left neighbour's on the rank. The JAX ring also
    sends the last rank's pair round to rank 0, which discards it; here that
    send is skipped. The carry is broadcast from the rank that holds it, so
    every rank can seed the next round.

    ragged=True returns fn(..., left_pair, n_valid) for a final short round:
    pad it to N windows (`pad_stream_round` repeats the last one), pass the
    true count `n_valid` (a Python int; JAX takes a traced scalar) and keep
    the rows of windows < n_valid. The carry is then the new pair of window
    n_valid - 1, which may sit on any rank. Padded windows are computed and
    discarded; they never feed a valid one (window k's first pair comes
    from window k - 1).
    """
    cfg = cfg or pwcnet.PWCNetConfig()
    n = axis_size(mesh, axis)
    shift = [(i, i + 1) for i in range(n - 1)]

    @torch.no_grad()
    def local_step(fisr_model, pwc_model, frames, left_pair):
        frames = _local_rows(mesh, axis, frames)
        f0, f1, f2 = frames[:, 0], frames[:, 1], frames[:, 2]
        flows_hi = _flow_core(pwc_model, f1, f2, cfg, policy, upscale)
        warps_hi = _warp_core(f1, f2, flows_hi)
        recv_f, recv_w = ppermute([flows_hi[-1:], warps_hi[-1:]], mesh, axis, shift)
        if axis_index(mesh, axis) == 0:
            recv_f, recv_w = (t[-1:].to(flows_hi.device) for t in left_pair)
        lo_f = torch.cat([recv_f, flows_hi[:-1]], 0)
        lo_w = torch.cat([recv_w, warps_hi[:-1]], 0)
        pred = _fisr_window_core(fisr_model, f0, f1, f2, lo_f, lo_w, flows_hi, warps_hi,
                                 policy, sf, fisr_grid)
        return pred, flows_hi, warps_hi

    def carry(flows_hi, warps_hi, window: int):
        """Window `window`'s new pair, taken from the rank that holds it."""
        holder, j = divmod(window, flows_hi.shape[0])
        pair = [flows_hi[j:j + 1].clone(), warps_hi[j:j + 1].clone()]
        return tuple(broadcast_from(pair, mesh, axis, holder))

    if ragged:
        def fn(fisr_model, pwc_model, frames, left_pair, n_valid):
            n_valid = int(n_valid)
            if not 0 < n_valid <= frames.shape[0]:
                raise ValueError(f"need 0 < n_valid <= {frames.shape[0]}, got {n_valid}")
            pred, flows_hi, warps_hi = local_step(fisr_model, pwc_model, frames, left_pair)
            return pred, carry(flows_hi, warps_hi, n_valid - 1)
    else:
        def fn(fisr_model, pwc_model, frames, left_pair):
            pred, flows_hi, warps_hi = local_step(fisr_model, pwc_model, frames, left_pair)
            return pred, carry(flows_hi, warps_hi, frames.shape[0] - 1)

    return fn


def pad_stream_round(windows, n_round: int):
    """For the ragged stream step: a short final round of consecutive
    windows [n, 3, h, w, C] padded to [n_round, ...] by repeating the last
    one, on the windows' own device (a tensor stays where it is; numpy
    becomes a CPU tensor). Returns (padded_windows, n_valid)."""
    n = windows.shape[0]
    if not 0 < n <= n_round:
        raise ValueError(f"need 0 < n <= {n_round} windows, got {n}")
    windows = torch.as_tensor(windows)
    if n == n_round:
        return windows, n
    pad = windows[-1:].expand((n_round - n,) + tuple(windows.shape[1:]))
    return torch.cat([windows, pad], 0), n
