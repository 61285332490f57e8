"""Sequence-tensor algebra: the "multiple data sample" sliding-window
framework (port of fisr_tpu/ops/seq.py).

The reference's sequence bookkeeping (ops.py:81-160 and its numpy twins in
utils.py:78-91) as pure functions on tensors:

* merge/split between 5-dim [N, S, H, W, C] and 4-dim [N, H, W, C*S] layouts
  (the model consumes merged channels; losses operate on the 5-dim form);
* channel-window slicing for the 3 temporal sliding windows per 5-frame
  sample (images stride 3 ch, flows stride 4 ch, warped frames stride 6 ch);
* overlap-averaging of adjacent window predictions into the final 7-frame
  sequence (ops.py:119-144, Fig. 3 of the paper).

Where the reference ran the model once per window (3 graph replicas,
FISRnet.py:281-306), `stack_windows` folds the windows into the batch axis,
so one apply covers all of them.
"""

from __future__ import annotations

import torch

__all__ = [
    "merge_seq_dim",
    "split_seq_dim",
    "window_channels",
    "stack_windows",
    "groups_to_overlap",
]

# Channel strides/widths of the merged per-modality layouts (ops.py:90-116).
IMG_STRIDE, IMG_WIDTH = 3, 9       # 3 frames x 3 YUV ch per window
FLOW_STRIDE, FLOW_WIDTH = 4, 8     # 4 bidirectional flows x (x,y) per window
WARP_STRIDE, WARP_WIDTH = 6, 12    # 4 warped frames x 3 YUV ch per window


def merge_seq_dim(x: torch.Tensor) -> torch.Tensor:
    """[N, S, H, W, C] -> [N, H, W, C*S] with channel-major frame packing.

    Parity: ops.py:147-152 / utils.py:78-83 (transpose to [N,H,W,S,C] then
    flatten the last two axes, so frame s occupies channels [s*C,(s+1)*C)).
    """
    n, s, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(n, h, w, s * c)


def split_seq_dim(x: torch.Tensor, frame_ch: int = 3) -> torch.Tensor:
    """[N, H, W, C*S] -> [N, S, H, W, C]; inverse of merge (ops.py:155-160)."""
    n, h, w, cs = x.shape
    s = cs // frame_ch
    return x.reshape(n, h, w, s, frame_ch).permute(0, 3, 1, 2, 4)


def window_channels(x: torch.Tensor, order: int, stride: int, width: int) -> torch.Tensor:
    """Slice sliding-window `order` from merged channels along the last axis.

    Parity: ops.py:90-116 (Tensor_slicer_recurrent{,_flow,_warp}).
    """
    return x[..., stride * order : stride * order + width]


def stack_windows(img: torch.Tensor, flow: torch.Tensor, warp: torch.Tensor,
                  n_windows: int = 3) -> torch.Tensor:
    """Build all stride-1 window inputs and fold them into the batch axis.

    img:  [B, H, W, 15]  (5 frames x 3ch merged)
    flow: [B, H, W, 16]  (8 flows x 2ch merged)
    warp: [B, H, W, 24]  (8 warped frames x 3ch merged)
    Returns [n_windows * B, H, W, 29]; window w occupies rows [w*B, (w+1)*B).
    """
    wins = []
    for i in range(n_windows):
        wins.append(
            torch.cat(
                [
                    window_channels(img, i, IMG_STRIDE, IMG_WIDTH),
                    window_channels(flow, i, FLOW_STRIDE, FLOW_WIDTH),
                    window_channels(warp, i, WARP_STRIDE, WARP_WIDTH),
                ],
                dim=-1,
            )
        )
    return torch.cat(wins, dim=0)


def groups_to_overlap(groups: torch.Tensor) -> torch.Tensor:
    """Average overlapping window predictions into the 7-frame sequence.

    groups: [B, 9, H, W, C] — 3 windows x 3 predicted frames, concatenated
    along the sequence axis. Output [B, 7, H, W, C]:
        [g0f0, g0f1, avg(g0f2, g1f0), g1f1, avg(g1f2, g2f0), g2f1, g2f2]
    Parity: ops.py:119-144 (Groups2Ovlp).
    """
    g = groups
    frames = [
        g[:, 0:1],
        g[:, 1:2],
        (g[:, 2:3] + g[:, 3:4]) * 0.5,
        g[:, 4:5],
        (g[:, 5:6] + g[:, 6:7]) * 0.5,
        g[:, 7:8],
        g[:, 8:9],
    ]
    return torch.cat(frames, dim=1)
