"""PWC-Net optical flow, pwcnet-lg-6-2 (port of fisr_tpu/models/pwcnet.py).

6 pyramid levels (16/32/64/96/128/196 channels, leaky-relu 0.1), flow
predicted at level 2, search range 4, dense estimator connections and a
residual context network; the cost volume at every level from 6 down to 2.
Submodule names follow the JAX key paths (`feat.level_1.a.weight`,
`flow.level_6.conv0.weight`, `up.level_6.feat.weight`, ...).

The cost volume is the one kernel of this path: with cost_volume_impl="auto"
a CUDA tensor goes to the Hopper kernel (fisr_tpu_torch/kernels/) and a CPU
tensor to the plain version; "kernel" and "plain" force one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fisr_tpu_torch.device import resolve_device
from fisr_tpu_torch.ops.conv import F32, Conv, Policy, conv2d, init_weights_
from fisr_tpu_torch.ops.resize import resize_tf1
from fisr_tpu_torch.ops.warp import dense_image_warp

PYR_CHANNELS = [None, 16, 32, 64, 96, 128, 196]  # 1-based
EST_CHANNELS = [128, 128, 96, 64, 32]
CTX_SPEC = [(128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1), (2, 1)]
COST_VOLUME_IMPLS = ("auto", "kernel", "plain")

__all__ = ["PWCNetConfig", "PWCNet", "apply", "apply_pyramids", "extract_features"]


class PWCNetConfig:
    """pwcnet-lg-6-2 defaults. cost_volume_impl: 'auto' (kernel for CUDA
    tensors, plain version for CPU tensors), 'kernel' or 'plain'."""

    def __init__(self, pyr_lvls: int = 6, flow_pred_lvl: int = 2,
                 search_range: int = 4, use_dense_cx: bool = True,
                 use_res_cx: bool = True, cost_volume_impl: str = "auto"):
        if cost_volume_impl not in COST_VOLUME_IMPLS:
            raise ValueError(f"cost_volume_impl {cost_volume_impl!r} not in {COST_VOLUME_IMPLS}")
        self.pyr_lvls = pyr_lvls
        self.flow_pred_lvl = flow_pred_lvl
        self.search_range = search_range
        self.use_dense_cx = use_dense_cx
        self.use_res_cx = use_res_cx
        self.cost_volume_impl = cost_volume_impl

    def cost_volume_fn(self):
        from fisr_tpu_torch.kernels import cost_volume as kernel
        from fisr_tpu_torch.ops.cost_volume import cost_volume as plain

        fn = {"auto": kernel.cost_volume, "kernel": kernel.cost_volume_cuda,
              "plain": plain}[self.cost_volume_impl]
        d = self.search_range
        return lambda a, b: fn(a.contiguous(), b.contiguous(), d)


class Deconv(nn.Module):
    """4x4 stride-2 transpose-conv parameters, torch layout [c_in, c_out, 4, 4]
    (TF conv2d_transpose's [4, 4, c_out, c_in] permuted (3, 2, 0, 1))."""

    def __init__(self, c_in: int, c_out: int = 2):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_in, c_out, 4, 4))
        self.bias = nn.Parameter(torch.zeros(c_out))


def _estimator_channels(cfg: PWCNetConfig, lvl: int) -> int:
    """Input channels of the estimator at `lvl` (corr [+ c1, flow, feat])."""
    od = (2 * cfg.search_range + 1) ** 2
    if lvl < cfg.pyr_lvls:
        od += PYR_CHANNELS[lvl] + 2 + 2
    return od


def _upfeat_channels(cfg: PWCNetConfig, lvl: int) -> int:
    od = _estimator_channels(cfg, lvl)
    return od + sum(EST_CHANNELS) if cfg.use_dense_cx else EST_CHANNELS[-1]


class PWCNet(nn.Module):
    """Parameters of PWC-Net under `cfg`; glorot-normal weights from `seed`."""

    def __init__(self, cfg: PWCNetConfig = PWCNetConfig(), seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.feat = nn.ModuleDict()
        c_prev = 3
        for lvl in range(1, cfg.pyr_lvls + 1):
            c = PYR_CHANNELS[lvl]
            self.feat[f"level_{lvl}"] = nn.ModuleDict(
                {"a": Conv(c_prev, c), "aa": Conv(c, c), "b": Conv(c, c)})
            c_prev = c
        self.flow, self.ctx, self.up = nn.ModuleDict(), nn.ModuleDict(), nn.ModuleDict()
        for lvl in range(cfg.pyr_lvls, cfg.flow_pred_lvl - 1, -1):
            est = nn.ModuleDict()
            c_in = _estimator_channels(cfg, lvl)
            for i, c in enumerate(EST_CHANNELS):
                est[f"conv{i}"] = Conv(c_in, c)
                c_in = c_in + c if cfg.use_dense_cx else c
            est["pred"] = Conv(c_in, 2)
            self.flow[f"level_{lvl}"] = est
            if cfg.use_res_cx or lvl == cfg.flow_pred_lvl:
                cx = nn.ModuleDict()
                cx_in = _upfeat_channels(cfg, lvl)
                for i, (c, _dil) in enumerate(CTX_SPEC):
                    cx[f"dc{i + 1}"] = Conv(cx_in, c)
                    cx_in = c
                self.ctx[f"level_{lvl}"] = cx
            if lvl != cfg.flow_pred_lvl:
                self.up[f"level_{lvl}"] = nn.ModuleDict({
                    "flow": Deconv(2), "feat": Deconv(_upfeat_channels(cfg, lvl))})
        init_weights_(self, seed)
        self.to(resolve_device(device))

    def forward(self, img1, img2, policy: Policy = F32):
        return apply(self, img1, img2, self.cfg, policy)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _deconv(p: Deconv, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    """tf.nn.conv2d_transpose, 4x4 stride 2 SAME: output 2H x 2W."""
    dt = policy.compute_dtype
    out = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), p.weight.to(dt),
                             p.bias.to(dt), stride=2, padding=1)
    return out.permute(0, 2, 3, 1)


def extract_features(p: PWCNet, x: torch.Tensor, cfg: PWCNetConfig,
                     policy: Policy = F32):
    """Siamese pyramid for one image batch: x [B, H, W, 3] -> [None, l1..lL]."""
    out = [None]
    n = policy.cast(x)
    for lvl in range(1, cfg.pyr_lvls + 1):
        lp = p.feat[f"level_{lvl}"]
        n = _leaky(conv2d(lp["a"], n, policy, stride=2))
        n = _leaky(conv2d(lp["aa"], n, policy))
        n = _leaky(conv2d(lp["b"], n, policy))
        out.append(n)
    return out


def _estimate(p: nn.ModuleDict, x: torch.Tensor, cfg: PWCNetConfig, policy: Policy):
    """Flow estimator with optional DenseNet concats; returns (upfeat, flow)."""
    for i in range(len(EST_CHANNELS)):
        act = _leaky(conv2d(p[f"conv{i}"], x, policy))
        x = torch.cat([act, x], dim=-1) if cfg.use_dense_cx else act
    return x, conv2d(p["pred"], x, policy)


def _refine(p: nn.ModuleDict, feat: torch.Tensor, flow: torch.Tensor,
            policy: Policy) -> torch.Tensor:
    x = feat
    for i, (_c, dil) in enumerate(CTX_SPEC):
        x = conv2d(p[f"dc{i + 1}"], x, policy, dilation=dil)
        if i < len(CTX_SPEC) - 1:
            x = _leaky(x)
    return flow + x


def apply(model: PWCNet, img1: torch.Tensor, img2: torch.Tensor,
          cfg: PWCNetConfig = PWCNetConfig(), policy: Policy = F32):
    """Flow img1 -> img2. img [B, H, W, 3] in [0, 1], H and W multiples of
    2**pyr_lvls. Returns (flow_pred [B, H, W, 2] in pixels, flow pyramid)."""
    c1 = extract_features(model, img1, cfg, policy)
    c2 = extract_features(model, img2, cfg, policy)
    return apply_pyramids(model, c1, c2, cfg, policy)


def apply_pyramids(model: PWCNet, c1, c2, cfg: PWCNetConfig = PWCNetConfig(),
                   policy: Policy = F32):
    """Flow from precomputed feature pyramids (extract_features outputs)."""
    cv = cfg.cost_volume_fn()
    flow_pyr = []
    up_flow = up_feat = None
    for lvl in range(cfg.pyr_lvls, cfg.flow_pred_lvl - 1, -1):
        if lvl == cfg.pyr_lvls:
            x = _leaky(cv(c1[lvl], c2[lvl]))
        else:
            # the reference's warp (tf.contrib dense_image_warp) subtracts the
            # flow and reads it as (dy, dx); ours adds (u, v), so it is given
            # -flip(flow), scaled to this level's pixels
            warped = dense_image_warp(c2[lvl], -torch.flip(up_flow, [-1]) * (20.0 / 2**lvl))
            corr = _leaky(cv(c1[lvl], warped))
            x = torch.cat([corr, c1[lvl], up_flow, up_feat], dim=-1)

        upfeat, flow = _estimate(model.flow[f"level_{lvl}"], x, cfg, policy)

        if lvl != cfg.flow_pred_lvl:
            if cfg.use_res_cx:
                flow = _refine(model.ctx[f"level_{lvl}"], upfeat, flow, policy)
            flow_pyr.append(flow)
            up_flow = _deconv(model.up[f"level_{lvl}"]["flow"], flow, policy)
            up_feat = _deconv(model.up[f"level_{lvl}"]["feat"], upfeat, policy)
        else:
            flow = _refine(model.ctx[f"level_{lvl}"], upfeat, flow, policy)
            flow_pyr.append(flow)
            scaler = 2**cfg.flow_pred_lvl
            h, w = flow.shape[1] * scaler, flow.shape[2] * scaler
            flow_pred = resize_tf1(flow.float(), (h, w), "bilinear") * scaler

    return flow_pred, flow_pyr
