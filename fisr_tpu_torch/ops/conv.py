"""Convolution vocabulary of FISRnet (port of fisr_tpu/ops/conv.py).

Parameters live in small `nn.Module` containers whose attribute names follow
the JAX key paths (`conv_in`, `res0.conv0`, ...); the ops are plain functions
`op(p, x, policy)` over NHWC tensors, as in the JAX package. Internally a
convolution runs on the NCHW view of the NHWC tensor (`permute`, no copy), so
cuDNN sees channels-last memory and the result permutes back for free.

These convolutions were XLA's on the TPU (no Pallas kernel), so here they are
cuDNN's through `torch.nn.functional`.

Precision policy: parameters stay f32; compute runs in `Policy.compute_dtype`
(bf16 on the card for speed, f32 for parity). f32 is full f32: the port's
entry points run an f32 policy inside `fisr_tpu_torch.device.exact_f32`,
which turns cuDNN's TF32 (PyTorch's default for convolutions) off and
restores it after. A caller of these functions directly under F32 on a card
gets what the backend flags say; `exact_f32` is the way to the reference's f32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from fisr_tpu_torch.ops.resize import resize_tf1, upsample2x_bilinear

__all__ = [
    "Policy", "F32", "BF16", "Conv", "ResBlock", "EncLevel", "Bottleneck",
    "DecLevel", "conv2d", "res_block", "max_pool_2x2",
    "enc_level", "bottleneck", "dec_level", "up_conv2x", "depth_to_space",
    "head_tail_conv", "init_weights_",
]


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: f32 master params, configurable compute dtype."""

    compute_dtype: torch.dtype = torch.float32

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


F32 = Policy(torch.float32)
BF16 = Policy(torch.bfloat16)


def init_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Glorot-normal kernels and zero biases from one torch.Generator seed
    (the JAX package's init_params; the two frameworks draw different numbers
    from the same seed). A [A, B, k, k] kernel, conv OIHW or transpose-conv
    IOHW, has the same fan sum k*k*(A+B) either way."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in sorted(model.named_parameters()):
            if t.ndim == 4:
                std = math.sqrt(2.0 / (t.shape[2] * t.shape[3] * (t.shape[0] + t.shape[1])))
                t.copy_(torch.randn(t.shape, generator=gen) * std)
            else:
                t.zero_()
    return model


class Conv(nn.Module):
    """k x k conv parameters: weight [c_out, c_in, k, k] (OIHW), bias [c_out]."""

    def __init__(self, c_in: int, c_out: int, k: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out))


class ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv0 = Conv(c, c)
        self.conv1 = Conv(c, c)


class EncLevel(nn.Module):
    def __init__(self, c_in: int, c: int):
        super().__init__()
        self.conv_in = Conv(c_in, c)
        self.res0 = ResBlock(c)
        self.res1 = ResBlock(c)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, c: int):
        super().__init__()
        self.conv_in = Conv(c_in, c)
        self.res0 = ResBlock(c)


class DecLevel(nn.Module):
    def __init__(self, c_in: int, c: int):
        super().__init__()
        self.resize = Conv(c_in, c)
        self.conv_in = Conv(c * 2, c)
        self.res0 = ResBlock(c)
        self.res1 = ResBlock(c)


def _same_pads(n: int, k: int, stride: int, dilation: int):
    """TF SAME padding (before, after) along one axis: for stride 2 on an even
    extent that is (0, 1), which torch's symmetric `padding=` cannot say."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def conv2d(p: Conv, x: torch.Tensor, policy: Policy = F32, *, stride: int = 1,
           dilation: int = 1) -> torch.Tensor:
    """SAME conv + bias, NHWC in and out, computed in the policy's dtype."""
    dt = policy.compute_dtype
    v = x.to(dt).permute(0, 3, 1, 2)
    k = p.weight.shape[-1]
    ph = _same_pads(v.shape[2], k, stride, dilation)
    pw = _same_pads(v.shape[3], k, stride, dilation)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        v = F.pad(v, (pw[0], pw[1], ph[0], ph[1]))
        pad = (0, 0)
    out = F.conv2d(v, p.weight.to(dt), p.bias.to(dt), stride, pad, dilation)
    return out.permute(0, 2, 3, 1)


def res_block(p: ResBlock, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
    n = conv2d(p.conv0, torch.relu(x), policy)
    n = conv2d(p.conv1, torch.relu(n), policy)
    return x + n


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool with TF SAME padding (an odd edge pools what it has)."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return out.permute(0, 2, 3, 1)


def enc_level(p: EncLevel, x: torch.Tensor, policy: Policy = F32):
    n = conv2d(p.conv_in, x, policy)
    n = res_block(p.res0, n, policy)
    skip = torch.relu(res_block(p.res1, n, policy))
    return max_pool_2x2(skip), skip


def bottleneck(p: Bottleneck, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
    n = conv2d(p.conv_in, x, policy)
    return torch.relu(res_block(p.res0, n, policy))


def dec_level(p: DecLevel, x: torch.Tensor, skip: torch.Tensor, size,
              policy: Policy = F32, fast_upsample: bool = False) -> torch.Tensor:
    doubles = (size[0], size[1]) == (x.shape[1] * 2, x.shape[2] * 2)
    if fast_upsample and doubles:
        n = torch.relu(up_conv2x(p.resize, x, policy))
    else:
        n = upsample2x_bilinear(x) if doubles else resize_tf1(x, size, "bilinear")
        n = torch.relu(conv2d(p.resize, n, policy))
    n = torch.cat([n, policy.cast(skip)], dim=-1)
    n = conv2d(p.conv_in, n, policy)
    n = res_block(p.res0, n, policy)
    return torch.relu(res_block(p.res1, n, policy))


# 1-D fold F[a][tap t][kernel tap d] of the TF1-legacy x2 bilinear stencil
# (up[2k] = x[k], up[2k+1] = (x[k] + x[k+1]) / 2) into a 3-tap conv.
_UP_FOLD = (((0.5, 0.0, 0.0),   # a=0: up rows 2i-1, 2i, 2i+1
             (0.5, 1.0, 0.5),
             (0.0, 0.0, 0.5)),
            ((0.0, 0.0, 0.0),   # a=1: up rows 2i, 2i+1, 2i+2
             (1.0, 0.5, 0.0),
             (0.0, 0.5, 1.0)))


def _fold_up_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """Fold `conv3x3(upsample2x_bilinear(x), w)` into a subpixel kernel.

    OIHW [Co, C, 3, 3] -> [4*Co, C, 3, 3]: output slot (a, b) of the
    x2-upsampled conv result is itself a 3x3 conv over the half-resolution
    input, whose taps are the original taps composed with the bilinear
    stencil:

        W'[(a,b,f), c, t, u] = sum_{d,e} F[a,t,d] * F[b,u,e] * w[f,c,d,e]

    The slot blocks come in TF depth_to_space (DCR) order, slot (a, b) at
    output channels (a*2+b)*Co .., so `depth_to_space(conv(x, W'), 2)`
    reproduces the composition.
    """
    f = torch.tensor(_UP_FOLD, dtype=w.dtype, device=w.device)
    wp = torch.einsum("atd,bue,fcde->abfctu", f, f, w)
    return wp.reshape(4 * w.shape[0], w.shape[1], 3, 3)


def up_conv2x(p: Conv, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
    """`conv2d(p, upsample2x_bilinear(x))` as one subpixel conv at the input's
    resolution, with 4*c_out output channels.

    The same function as the composition except on a thin frame border: the
    first output row and column (the conv's zero pad sits between two taps of
    the upsample stencil, which the fold cannot say) and the last two (the
    legacy upsample clamps its last interpolated row, the fold reads the zero
    pad). Patch-tiled inference trims at least 2 px everywhere but at the
    true canvas border, so the inference paths opt in (`fast_upsample`).

    The weight is folded on every call, so an updated weight is never met
    by a stale fold: 0.35-0.41 ms a call, twice a tiled window of 88 ms
    (NVIDIA H100 80GB HBM3 at 700 W, `chip_smoke.py`, phase `tiled`).
    """
    dt = policy.compute_dtype
    wp = _fold_up_conv_weights(p.weight).to(dt)
    out = F.conv2d(x.to(dt).permute(0, 3, 1, 2), wp, None, 1, 1).permute(0, 2, 3, 1)
    return depth_to_space(out, 2) + p.bias.to(dt)


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """TF `tf.depth_to_space` (DCR order), NHWC. `torch.pixel_shuffle` orders
    the channels the other way (CRD), so it is not this function."""
    n, h, w, c = x.shape
    c_out = c // (block * block)
    x = x.reshape(n, h, w, block, block, c_out).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * block, w * block, c_out)


def head_tail_conv(p: Conv, m: torch.Tensor, policy: Policy = F32,
                   block: int = 2) -> torch.Tensor:
    """relu -> depth_to_space(block) -> 3x3 SAME conv: the head tail.

    For block 2 the JAX package computes this as one packed tap-GEMM at a
    quarter of the resolution (a TPU lane-occupancy rewrite); the function
    is the same, and this is its plain composition."""
    return conv2d(p, depth_to_space(torch.relu(policy.cast(m)), block), policy)
