"""FISRnet: 3-level coarse-to-fine joint VFI+SR U-Net stack (port of
fisr_tpu/models/fisrnet.py).

input [B, H, W, 29] = 3 YUV frames (9) + 4 flows (8) + 4 warped frames (12),
H and W multiples of 32. level_1 runs on the x1/4 input, level_2 on the x1/2
input concatenated with level_1's 9-channel prediction, level_3 on the full
input concatenated with level_2's. Each level: 3 encoder stages, a
bottleneck, 3 decoder stages and two heads (FI-SR: 6 channels, SR: 3), each
conv -> res block -> conv(ch*sf^2) -> depth_to_space(sf) -> conv. About
16.1 M parameters a level at ch=64.

Submodule names follow the JAX key paths, e.g.
`level_1.enc.level_0.conv_in.weight` <-> ("level_1", "enc", "level_0",
"conv_in", "w").
"""

from __future__ import annotations

import torch
from torch import nn

from fisr_tpu_torch.device import resolve_device
from fisr_tpu_torch.ops.conv import (
    F32, Bottleneck, Conv, DecLevel, EncLevel, Policy, ResBlock, bottleneck,
    conv2d, dec_level, enc_level, head_tail_conv, init_weights_, res_block,
)
from fisr_tpu_torch.ops.resize import downsample_int

BASE_CH = 64
IN_CH = 29  # 9 img + 8 flow + 12 warp
PRED_CH = 9  # [fr1(3), SR(3), fr2(3)]

__all__ = ["FISRnet", "apply", "apply_level", "apply_heads", "param_count",
           "BASE_CH", "IN_CH", "PRED_CH"]


class Head(nn.Module):
    def __init__(self, ch: int, out_ch: int, sf: int):
        super().__init__()
        self.conv0 = Conv(ch, ch)
        self.res0 = ResBlock(ch)
        self.conv1 = Conv(ch, ch * sf * sf)
        self.conv2 = Conv(ch, out_ch)


class Level(nn.Module):
    def __init__(self, in_ch: int, ch: int, sf: int):
        super().__init__()
        self.enc = nn.ModuleDict({
            "level_0": EncLevel(in_ch, ch),
            "level_1": EncLevel(ch, ch * 2),
            "level_2": EncLevel(ch * 2, ch * 4),
        })
        self.bottleneck = Bottleneck(ch * 4, ch * 8)
        self.dec = nn.ModuleDict({
            "level_2": DecLevel(ch * 8, ch * 4),
            "level_1": DecLevel(ch * 4, ch * 2),
            "level_0": DecLevel(ch * 2, ch),
        })
        self.fisr = Head(ch, 6, sf)
        self.sr = Head(ch, 3, sf)


class FISRnet(nn.Module):
    """Three separately weighted levels; levels 2 and 3 also see the previous
    level's 9-channel prediction. Weights: glorot-normal from `seed`."""

    def __init__(self, in_ch: int = IN_CH, sf: int = 2, ch: int = BASE_CH,
                 seed: int = 0, device="cuda"):
        super().__init__()
        self.sf = sf
        self.level_1 = Level(in_ch, ch, sf)
        self.level_2 = Level(in_ch + PRED_CH, ch, sf)
        self.level_3 = Level(in_ch + PRED_CH, ch, sf)
        init_weights_(self, seed)
        self.to(resolve_device(device))

    def forward(self, img: torch.Tensor, policy: Policy = F32):
        return apply(self, img, self.sf, policy)


def apply_heads(p: Level, n: torch.Tensor, sf: int = 2, policy: Policy = F32) -> torch.Tensor:
    """Both heads on the last decoder features n [B, h, w, ch] ->
    [B, h*sf, w*sf, 9] = concat [fr1, SR, fr2]. Receptive radius 6 px at n's
    scale. The JAX package merges the two heads' conv0 into one conv to fill
    the TPU's output lanes; the function is the same, and here they are two
    convs."""

    def run_head(hp: Head) -> torch.Tensor:
        m = conv2d(hp.conv0, n, policy)
        m = res_block(hp.res0, m, policy)
        m = conv2d(hp.conv1, torch.relu(m), policy)
        return head_tail_conv(hp.conv2, m, policy, sf)

    pred_fisr = run_head(p.fisr)  # [fr1, fr2]
    pred_sr = run_head(p.sr)
    return torch.cat([pred_fisr[..., :3], pred_sr, pred_fisr[..., 3:]], dim=-1)


# Receptive radii (input px) of the pipeline's suffix from each cut point:
# dec0 reads 8 (x2 upsample 2 + resize conv 1 + conv_in 1 + 2 res blocks 4)
# and the heads 6 (conv0 1 + res0 2 + conv1 1 + the x2-scale tail conv 1).
# Both are rounded up to multiples of 8 as in the JAX package (whose TPU tile
# layout wants 8-aligned slices); the port keeps the values so that it trims
# the same cells, and a larger tail only keeps more of the ring.
_TAIL_DEC0 = 16
_TAIL_HEADS = 8


def apply_level(p: Level, x: torch.Tensor, sf: int = 2, policy: Policy = F32,
                stale_halo: int = 0, fast_upsample: bool = False) -> torch.Tensor:
    """One U-Net level: x [B, h, w, C] -> prediction [B, h*sf, w*sf, 9].

    stale_halo: the caller tiled the frame and x carries a ring of
    `stale_halo` px that will be cut from the output (infer/device.
    tiled_apply). The ring only has to live as long as the rest of the
    pipeline reads it: it is trimmed to _TAIL_DEC0 px before dec0 and to
    _TAIL_HEADS px before the heads, and the prediction comes back with a
    ring of _TAIL_HEADS*sf px. The cells removed influence only cells that
    are removed, so the retained output is the same function as with the
    full ring; whether it is the same bits depends on the conv library
    choosing one algorithm for both extents (tests/test_torch_models.py
    states what was measured). Requires stale_halo == 0, or >= _TAIL_DEC0
    with the cut a multiple of 8.

    fast_upsample: dec1 and dec0 run their x2 upsample + conv as one folded
    subpixel conv (ops/conv.up_conv2x), exact except at the frame border.
    dec2 never does: its 1-px border deviation sits at 1/4 scale and the
    ~30-px receptive tail after it would carry it past a 32-px halo.
    """
    x = policy.cast(x)
    h, w = x.shape[1], x.shape[2]
    n, skip0 = enc_level(p.enc["level_0"], x, policy)
    n, skip1 = enc_level(p.enc["level_1"], n, policy)
    n, skip2 = enc_level(p.enc["level_2"], n, policy)
    n = bottleneck(p.bottleneck, n, policy)
    n = dec_level(p.dec["level_2"], n, skip2, (h // 4, w // 4), policy)
    n = dec_level(p.dec["level_1"], n, skip1, (h // 2, w // 2), policy, fast_upsample)

    if stale_halo:
        if stale_halo < _TAIL_DEC0 or (stale_halo - _TAIL_DEC0) % 8:
            raise ValueError(f"stale_halo {stale_halo}: want 0, or >= {_TAIL_DEC0} "
                             "with the cut a multiple of 8")
        cut = stale_halo - _TAIL_DEC0
        c2 = cut // 2
        n = n[:, c2:n.shape[1] - c2, c2:n.shape[2] - c2, :]
        skip0 = skip0[:, cut:skip0.shape[1] - cut, cut:skip0.shape[2] - cut, :]
        h, w = h - 2 * cut, w - 2 * cut

    n = dec_level(p.dec["level_0"], n, skip0, (h, w), policy, fast_upsample)

    if stale_halo:
        c2 = _TAIL_DEC0 - _TAIL_HEADS
        n = n[:, c2:n.shape[1] - c2, c2:n.shape[2] - c2, :]

    return apply_heads(p, n, sf, policy)


def apply(model: FISRnet, img: torch.Tensor, sf: int = 2, policy: Policy = F32,
          final_stale_halo: int = 0, fast_upsample: bool = False):
    """Full 3-level stack. img [B, H, W, 29] -> (pred_l1, pred_l2, pred_l3) at
    (H/2, H, 2H). The x1/4 and x1/2 inputs are the TF1-legacy bicubic, which
    for integer factors is subsampling.

    final_stale_halo: a ring on img that the caller will cut away; level 3
    may shrink it on the way (apply_level). Levels 1 and 2 keep it: their
    predictions feed the next level's input and must stay full size. pred_l3
    then carries a ring of _TAIL_HEADS*sf px.

    fast_upsample goes to level 3 only: the internal scales of levels 1 and 2
    are 1/4 to 1/16 of the window, so the folded upconv's 1-px border
    deviation would span 16 and more window px there and spread through
    pred_l1 and pred_l2 into every pixel of level 3.
    """
    img = policy.cast(img)
    pred_l1 = apply_level(model.level_1, downsample_int(img, 4), sf, policy)
    img_l2 = torch.cat([downsample_int(img, 2), pred_l1], dim=-1)
    pred_l2 = apply_level(model.level_2, img_l2, sf, policy)
    img_l3 = torch.cat([img, pred_l2], dim=-1)
    pred_l3 = apply_level(model.level_3, img_l3, sf, policy, stale_halo=final_stale_halo,
                          fast_upsample=fast_upsample)
    return pred_l1, pred_l2, pred_l3


def param_count(model: nn.Module) -> int:
    return sum(t.numel() for t in model.parameters())
