"""YUV <-> RGB (BT.601, MATLAB ycbcr2rgb / rgb2ycbcr), port of
fisr_tpu/ops/color.py.

[0, 255]-range values, channel axis last, any leading shape. The 3x3
transforms are written as f32 elementwise multiply-adds, not a matmul: on the
card a f32 matmul may run in TF32, which would change the digits.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["yuv2rgb_matlab", "rgb2yuv_matlab", "yuv2rgb_matlab_u8", "rgb2yuv_matlab_u8",
           "yuv2rgb_float"]

# MATLAB ycbcr2rgb inverse matrix (reference utils.py:107), rows R, G, B.
_TINV = np.array(
    [
        [0.00456621, 0.0, 0.00625893],
        [0.00456621, -0.00153632, -0.00318811],
        [0.00456621, 0.00791071, 0.0],
    ],
    dtype=np.float64,
)
_OFFSET_YUV = np.array([16.0, 128.0, 128.0], dtype=np.float64)
_M_YUV2RGB = (255.0 * _TINV).astype(np.float32)
_B_YUV2RGB = (255.0 * _TINV @ _OFFSET_YUV).astype(np.float32)

_T_FWD = np.array(
    [
        [65.481, 128.553, 24.966],
        [-37.797, -74.203, 112.0],
        [112.0, -93.786, -18.214],
    ],
    dtype=np.float64,
)
_M_RGB2YUV = (_T_FWD / 255.0).astype(np.float32)
_B_RGB2YUV = _OFFSET_YUV.astype(np.float32)

# The reference's other YUV -> RGB (utils.py:94-103): the MATLAB matrix
# multiplied out into float constants, not clipped. No caller in the port; kept
# beside the MATLAB one as the JAX package keeps it.
_M_YUV2RGB_FLOAT = np.array(
    [
        [1.0, -0.000007154783816076815, 1.4019975662231445],
        [1.0, -0.3441331386566162, -0.7141380310058594],
        [1.0, 1.7720025777816772, 0.00001542569043522235],
    ],
    dtype=np.float32,
)
_B_YUV2RGB_FLOAT = np.array(
    [179.45477266423404, -135.45870971679688, 226.8183044444304], np.float32
)


def _apply_3x3(x: torch.Tensor, m: np.ndarray, b: np.ndarray, sign: float) -> torch.Tensor:
    """out[..., r] = sum_c m[r, c] * x[..., c] + sign * b[r], in f32."""
    x = x.float()
    ch = [x[..., c] for c in range(3)]
    outs = [
        float(m[r, 0]) * ch[0] + float(m[r, 1]) * ch[1] + float(m[r, 2]) * ch[2]
        + float(np.float32(sign * b[r]))
        for r in range(3)
    ]
    return torch.stack(outs, dim=-1)


def yuv2rgb_matlab(yuv: torch.Tensor, clip: bool = True) -> torch.Tensor:
    """MATLAB-equivalent YUV([0,255]) -> RGB([0,255])."""
    rgb = _apply_3x3(yuv, _M_YUV2RGB, _B_YUV2RGB, -1.0)
    return rgb.clamp(0.0, 255.0) if clip else rgb


def yuv2rgb_float(yuv: torch.Tensor) -> torch.Tensor:
    """YUV([0,255]) -> RGB with the float constants of utils.py:94-103,
    unclipped (unlike yuv2rgb_matlab)."""
    return _apply_3x3(yuv, _M_YUV2RGB_FLOAT, _B_YUV2RGB_FLOAT, -1.0)


def rgb2yuv_matlab(rgb: torch.Tensor, clip: bool = True) -> torch.Tensor:
    """MATLAB-equivalent RGB([0,255]) -> YUV([0,255])."""
    yuv = _apply_3x3(rgb, _M_RGB2YUV, _B_RGB2YUV, 1.0)
    return yuv.clamp(0.0, 255.0) if clip else yuv


def yuv2rgb_matlab_u8(yuv_u8: np.ndarray) -> np.ndarray:
    """Host-side uint8 YUV -> uint8 RGB exactly as the reference save path:
    f64 transform, clip, then truncation by `.astype('uint8')`."""
    rgb = (yuv_u8.astype(np.float64) @ _M_YUV2RGB.T.astype(np.float64)) - _B_YUV2RGB.astype(np.float64)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def rgb2yuv_matlab_u8(rgb_u8: np.ndarray) -> np.ndarray:
    """Host-side uint8 RGB -> uint8 YUV as the JAX package converts corpus
    frames (fisr_tpu/native/bindings.py, its numpy route): the f32 transform,
    clip, then truncation."""
    rgb = torch.from_numpy(np.ascontiguousarray(rgb_u8, np.uint8))
    return rgb2yuv_matlab(rgb).numpy().astype(np.uint8)
