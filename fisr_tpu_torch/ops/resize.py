"""TF1-compatible image resize, legacy coordinate transform (port of
fisr_tpu/ops/resize.py).

FISRnet and PWC-Net were built on TF 1.13 `tf.image.resize_images` with
align_corners=False and the legacy (non-half-pixel) transform

    in_coord = out_coord * (in_size / out_size)

No `torch.nn.functional.interpolate` mode matches it (they use half-pixel
centres or align the corners), so the index and weight tables are ported.

Exact identities under the legacy transform, used below:
* integer-factor downscale is subsampling (`x[::f]`), bilinear or bicubic;
* bilinear x2^k upscale is k chained x2 upscales.

The spatial axes are the third- and second-to-last (NHWC, or any leading
shape before H, W, C).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize_tf1", "upsample2x_bilinear", "downsample_int"]


def _keys_cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with A=-0.75 (TF / OpenCV convention)."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def _interp_tables(in_size: int, out_size: int, method: str):
    """(idx int64 [taps, out], w float32 [taps, out]) for 1-D legacy-transform
    interpolation. Indices clamp to [0, in_size-1]; weights are the raw kernel
    values, not renormalised (TF legacy behaviour)."""
    scale = in_size / out_size
    coords = np.arange(out_size, dtype=np.float64) * scale
    base = np.floor(coords).astype(np.int64)
    frac = coords - base
    if method == "bilinear":
        offsets = np.array([0, 1])
        weights = np.stack([1.0 - frac, frac])
    elif method == "bicubic":
        offsets = np.array([-1, 0, 1, 2])
        weights = np.stack([_keys_cubic(frac - o) for o in offsets])
    else:
        raise ValueError(f"unknown resize method: {method}")
    idx = np.clip(base[None, :] + offsets[:, None], 0, in_size - 1)
    return idx.astype(np.int64), weights.astype(np.float32)


def _resize_axis(x: torch.Tensor, out_size: int, axis: int, method: str) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if in_size % out_size == 0:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, in_size, in_size // out_size)
        return x[tuple(sl)]
    idx, w = _interp_tables(in_size, out_size, method)
    wshape = [1] * x.ndim
    wshape[axis] = out_size
    acc = None
    for t in range(idx.shape[0]):
        tap = x.index_select(axis, torch.from_numpy(idx[t]).to(x.device))
        wt = torch.from_numpy(w[t]).reshape(wshape).to(x.device, x.dtype)
        acc = tap * wt if acc is None else acc + tap * wt
    return acc


def resize_tf1(x: torch.Tensor, size, method: str = "bilinear") -> torch.Tensor:
    """Resize `x` [..., H, W, C] to spatial `size` with TF1 legacy semantics."""
    h_axis, w_axis = x.ndim - 3, x.ndim - 2
    h, w = x.shape[h_axis], x.shape[w_axis]
    if method == "bilinear" and size[0] % h == 0 and size[1] % w == 0:
        fh, fw = size[0] // h, size[1] // w
        if fh == fw and fh in (2, 4, 8, 16):
            for _ in range(fh.bit_length() - 1):
                x = upsample2x_bilinear(x)
            return x
    x = _resize_axis(x, size[0], h_axis, method)
    return _resize_axis(x, size[1], w_axis, method)


def _up_axis(v: torch.Tensor, axis: int) -> torch.Tensor:
    n = v.shape[axis]
    nxt = torch.cat([v.narrow(axis, 1, n - 1), v.narrow(axis, n - 1, 1)], dim=axis)
    half = (v + nxt) * 0.5
    shape = list(v.shape)
    shape[axis] *= 2
    return torch.stack([v, half], dim=axis + 1).reshape(shape)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Exact TF1-legacy bilinear x2 upsample: out[2i] = in[i],
    out[2i+1] = (in[i] + in[i+1]) / 2, the last odd output reading in[i] twice."""
    return _up_axis(_up_axis(x, x.ndim - 3), x.ndim - 2)


def downsample_int(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor legacy-transform downscale == strided subsampling."""
    return x[..., ::factor, ::factor, :]
