"""Frozen plain PWC-Net, lg-6-2 (Sun et al., CVPR 2018; philferriere/tfoptflow
`pwcnet-lg-6-2-multisteps-chairsthingsmix`): six pyramid levels
(16/32/64/96/128/196 channels, leaky ReLU 0.1), flow predicted at level 2,
search range 4, dense estimator connections and a residual context network,
in float32 and untiled.

Parameters come as a dict {name: tensor} (`feat.level_1.a.weight`,
`flow.level_6.conv0.weight`, `ctx.level_2.dc1.weight`,
`up.level_6.feat.weight`, ...); transposed-conv kernels are [c_in, c_out, 4, 4].
"""

from __future__ import annotations

import torch

from fisrbench.reference.ops import Numerics, leaky, resize_bilinear, warp

PYR = [None, 16, 32, 64, 96, 128, 196]
EST = [128, 128, 96, 64, 32]
CTX = [(128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1), (2, 1)]


def _est_in(lvl, top, d):
    od = (2 * d + 1) ** 2
    return od + (PYR[lvl] + 4 if lvl < top else 0)


def param_shapes(pyr_lvls: int = 6, flow_pred_lvl: int = 2, search_range: int = 4,
                 **_) -> dict:
    out = {}

    def conv(name, ci, co):
        out[f"{name}.weight"] = (co, ci, 3, 3)
        out[f"{name}.bias"] = (co,)

    c_prev = 3
    for lvl in range(1, pyr_lvls + 1):
        conv(f"feat.level_{lvl}.a", c_prev, PYR[lvl])
        conv(f"feat.level_{lvl}.aa", PYR[lvl], PYR[lvl])
        conv(f"feat.level_{lvl}.b", PYR[lvl], PYR[lvl])
        c_prev = PYR[lvl]
    for lvl in range(pyr_lvls, flow_pred_lvl - 1, -1):
        ci = _est_in(lvl, pyr_lvls, search_range)
        for i, c in enumerate(EST):
            conv(f"flow.level_{lvl}.conv{i}", ci, c)
            ci += c
        conv(f"flow.level_{lvl}.pred", ci, 2)
        cx = ci
        for i, (c, _dil) in enumerate(CTX):
            conv(f"ctx.level_{lvl}.dc{i + 1}", cx, c)
            cx = c
        if lvl != flow_pred_lvl:
            out[f"up.level_{lvl}.flow.weight"] = (2, 2, 4, 4)
            out[f"up.level_{lvl}.flow.bias"] = (2,)
            out[f"up.level_{lvl}.feat.weight"] = (ci, 2, 4, 4)
            out[f"up.level_{lvl}.feat.bias"] = (2,)
    return out


class PWCNetRef:
    def __init__(self, params: dict, pyr_lvls: int = 6, flow_pred_lvl: int = 2,
                 search_range: int = 4, numerics: Numerics | None = None, **_):
        self.p = params
        self.top, self.bottom, self.d = pyr_lvls, flow_pred_lvl, search_range
        self.nx = numerics or Numerics()

    def _conv(self, name, x, stride=1, dilation=1):
        return self.nx.conv(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"], stride,
                            dilation)

    def features(self, x):
        """x [B, H, W, 3] -> [None, level 1 .. level 6]."""
        out = [None]
        for lvl in range(1, self.top + 1):
            x = leaky(self._conv(f"feat.level_{lvl}.a", x, stride=2))
            x = leaky(self._conv(f"feat.level_{lvl}.aa", x))
            x = leaky(self._conv(f"feat.level_{lvl}.b", x))
            out.append(x)
        return out

    def flows(self, c1, c2):
        """Pyramids of both images -> (flow [B, H, W, 2] in pixels, the
        per-level flows, coarsest first)."""
        pyr = []
        up_flow = up_feat = None
        for lvl in range(self.top, self.bottom - 1, -1):
            if lvl == self.top:
                x = leaky(self.nx.cost_volume(c1[lvl], c2[lvl], self.d))
            else:
                # the flow is (u, v); tf.contrib's warp subtracts a (dy, dx)
                warped = warp(c2[lvl], -torch.flip(up_flow, [-1]) * (20.0 / 2 ** lvl))
                corr = leaky(self.nx.cost_volume(c1[lvl], warped, self.d))
                x = torch.cat([corr, c1[lvl], up_flow, up_feat], dim=-1)
            for i in range(len(EST)):
                x = torch.cat([leaky(self._conv(f"flow.level_{lvl}.conv{i}", x)), x], dim=-1)
            flow = self._conv(f"flow.level_{lvl}.pred", x)
            r = x
            for i, (_c, dil) in enumerate(CTX):
                r = self._conv(f"ctx.level_{lvl}.dc{i + 1}", r, dilation=dil)
                if i < len(CTX) - 1:
                    r = leaky(r)
            flow = flow + r
            pyr.append(flow)
            if lvl != self.bottom:
                up_flow = self.nx.deconv(flow, self.p[f"up.level_{lvl}.flow.weight"],
                                         self.p[f"up.level_{lvl}.flow.bias"])
                up_feat = self.nx.deconv(x, self.p[f"up.level_{lvl}.feat.weight"],
                                         self.p[f"up.level_{lvl}.feat.bias"])
        s = 2 ** self.bottom
        full = resize_bilinear(flow, (flow.shape[1] * s, flow.shape[2] * s)) * s
        return full, pyr

    def __call__(self, img1, img2):
        return self.flows(self.features(img1), self.features(img2))
