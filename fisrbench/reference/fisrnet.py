"""Frozen plain FISRnet (Kim, Oh and Kim, "FISR", AAAI 2020; arXiv:1912.07213):
the 3-level coarse-to-fine U-Net stack, full frame, in float32.

Parameters come as a dict {name: tensor} under the names of the
configuration's layout (`level_1.enc.level_0.conv_in.weight`, ...), OIHW
kernels. Level 1 sees the x1/4 input, level 2 the x1/2 input with level 1's
prediction, level 3 the full input with level 2's. Each level: three encoder
stages, a bottleneck, three decoder stages and two heads (FI-SR 6 channels,
SR 3), each head conv -> res block -> conv(ch * sf^2) -> relu ->
depth_to_space(sf) -> conv.
"""

from __future__ import annotations

import torch

from fisrbench.reference.ops import Numerics, resize_bilinear, upsample2x

LEVELS = ("level_1", "level_2", "level_3")


def param_shapes(in_ch: int = 29, ch: int = 64, sf: int = 2, pred_ch: int = 9) -> dict:
    """{name: shape} of every parameter."""
    out = {}

    def conv(name, ci, co):
        out[f"{name}.weight"] = (co, ci, 3, 3)
        out[f"{name}.bias"] = (co,)

    def res(name, c):
        conv(f"{name}.conv0", c, c)
        conv(f"{name}.conv1", c, c)

    for li, lvl in enumerate(LEVELS):
        cin = in_ch if li == 0 else in_ch + pred_ch
        for i, (a, b) in enumerate(((cin, ch), (ch, 2 * ch), (2 * ch, 4 * ch))):
            conv(f"{lvl}.enc.level_{i}.conv_in", a, b)
            res(f"{lvl}.enc.level_{i}.res0", b)
            res(f"{lvl}.enc.level_{i}.res1", b)
        conv(f"{lvl}.bottleneck.conv_in", 4 * ch, 8 * ch)
        res(f"{lvl}.bottleneck.res0", 8 * ch)
        for i, (a, b) in ((2, (8 * ch, 4 * ch)), (1, (4 * ch, 2 * ch)), (0, (2 * ch, ch))):
            conv(f"{lvl}.dec.level_{i}.resize", a, b)
            conv(f"{lvl}.dec.level_{i}.conv_in", 2 * b, b)
            res(f"{lvl}.dec.level_{i}.res0", b)
            res(f"{lvl}.dec.level_{i}.res1", b)
        for head, oc in (("fisr", 6), ("sr", 3)):
            conv(f"{lvl}.{head}.conv0", ch, ch)
            res(f"{lvl}.{head}.res0", ch)
            conv(f"{lvl}.{head}.conv1", ch, ch * sf * sf)
            conv(f"{lvl}.{head}.conv2", ch, oc)
    return out


def _depth_to_space(x, block):
    """TF depth_to_space (DCR order), NHWC."""
    n, h, w, c = x.shape
    co = c // (block * block)
    x = x.reshape(n, h, w, block, block, co).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * block, w * block, co)


class FISRnetRef:
    def __init__(self, params: dict, sf: int = 2, numerics: Numerics | None = None):
        self.p = params
        self.sf = sf
        self.nx = numerics or Numerics()

    def _conv(self, name, x):
        return self.nx.conv(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"])

    def _res(self, name, x):
        n = self._conv(f"{name}.conv0", torch.relu(x))
        n = self._conv(f"{name}.conv1", torch.relu(n))
        return x + n

    def _enc(self, name, x):
        n = self._conv(f"{name}.conv_in", x)
        n = self._res(f"{name}.res0", n)
        skip = torch.relu(self._res(f"{name}.res1", n))
        pooled = torch.nn.functional.max_pool2d(skip.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
        return pooled.permute(0, 2, 3, 1), skip

    def _dec(self, name, x, skip, size):
        if tuple(size) == (2 * x.shape[1], 2 * x.shape[2]):
            n = upsample2x(x)
        else:
            n = resize_bilinear(x, size)
        n = torch.relu(self._conv(f"{name}.resize", n))
        n = self._conv(f"{name}.conv_in", torch.cat([n, skip], dim=-1))
        n = self._res(f"{name}.res0", n)
        return torch.relu(self._res(f"{name}.res1", n))

    def _head(self, name, n):
        m = self._conv(f"{name}.conv0", n)
        m = self._res(f"{name}.res0", m)
        m = self._conv(f"{name}.conv1", torch.relu(m))
        return self._conv(f"{name}.conv2", _depth_to_space(torch.relu(m), self.sf))

    def level(self, lvl, x):
        h, w = x.shape[1], x.shape[2]
        n, s0 = self._enc(f"{lvl}.enc.level_0", x)
        n, s1 = self._enc(f"{lvl}.enc.level_1", n)
        n, s2 = self._enc(f"{lvl}.enc.level_2", n)
        n = self._conv(f"{lvl}.bottleneck.conv_in", n)
        n = torch.relu(self._res(f"{lvl}.bottleneck.res0", n))
        n = self._dec(f"{lvl}.dec.level_2", n, s2, (h // 4, w // 4))
        n = self._dec(f"{lvl}.dec.level_1", n, s1, (h // 2, w // 2))
        n = self._dec(f"{lvl}.dec.level_0", n, s0, (h, w))
        fisr = self._head(f"{lvl}.fisr", n)
        sr = self._head(f"{lvl}.sr", n)
        return torch.cat([fisr[..., :3], sr, fisr[..., 3:]], dim=-1)

    def __call__(self, img):
        """img [B, H, W, 29] -> the level-3 prediction [B, 2H, 2W, 9]
        ([interp1, SR, interp2]), before any clip."""
        p1 = self.level("level_1", img[:, ::4, ::4, :])
        p2 = self.level("level_2", torch.cat([img[:, ::2, ::2, :], p1], dim=-1))
        return self.level("level_3", torch.cat([img, p2], dim=-1))
