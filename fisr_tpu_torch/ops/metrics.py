"""PSNR / SSIM evaluation metrics (port of fisr_tpu/ops/metrics.py).

* `psnr_np`       - the reference's numpy PSNR (utils.py:23-26):
                    10*log10(peak^2 / mse) over the whole array, in float64.
* `psnr_image`    - PSNR per image over the last 3 axes, as `tf.image.psnr`
                    (train and validation PSNR, FISRnet.py:485-486, 532-533).
* `ssim`          - SSIM, Wang et al. 2004: 11x11 Gaussian window sigma=1.5,
                    K1=0.01, K2=0.03, mean over channels; in float32, pinned
                    to `tf.image.ssim` (tests/fixtures/tf_oracle/ssim_tf.npz).
* `ssim_pil_like` - the reference's scorer, SSIM_PIL.compare_ssim on uint8
                    images (FISRnet.py:890-891): non-overlapping tile_size x
                    tile_size tiles, unweighted tile statistics pooled over
                    the colour bands (population statistics, as
                    PIL.ImageStat), L=255, pixels beyond the last full tile
                    dropped, mean over tiles. numpy, float64.

`psnr_image` and `ssim` take tensors or numpy arrays and compute where a
tensor lives (a numpy array is a CPU tensor).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["psnr_np", "psnr_image", "ssim", "ssim_pil_like"]


def psnr_np(img_orig: np.ndarray, img_out: np.ndarray, peak: float = 1.0) -> float:
    mse = np.mean(np.square(img_orig - img_out))
    return float(10.0 * np.log10(peak * peak / mse))


def psnr_image(a, b, max_val: float = 1.0) -> torch.Tensor:
    """PSNR per image over the trailing [H, W, C] axes (tf.image.psnr)."""
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    mse = torch.mean(torch.square(a - b), dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val * max_val / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


def _filter2d_valid(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable VALID depthwise filter over H, W of NCHW x."""
    c = x.shape[1]
    x = F.conv2d(x, k1d.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, k1d.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def ssim(a, b, max_val: float = 1.0, filter_size: int = 11, filter_sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM per image pair; a, b: [B, H, W, C] (or [H, W, C]). Runs in
    f32 on a's device, with TF32 off for its filters."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    squeeze = a.ndim == 3
    if squeeze:
        a, b = a[None], b[None]
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().to(a.device).permute(0, 3, 1, 2)
    k = torch.from_numpy(_gaussian_kernel(filter_size, filter_sigma)).to(a.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
        mu_a = _filter2d_valid(a, k)
        mu_b = _filter2d_valid(b, k)
        mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        sigma_aa = _filter2d_valid(a * a, k) - mu_aa
        sigma_bb = _filter2d_valid(b * b, k) - mu_bb
        sigma_ab = _filter2d_valid(a * b, k) - mu_ab
    num = (2.0 * mu_ab + c1) * (2.0 * sigma_ab + c2)
    den = (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2)
    s = torch.mean(num / den, dim=(-3, -2, -1))
    return s[0] if squeeze else s


def ssim_pil_like(a: np.ndarray, b: np.ndarray, tile_size: int = 7,
                  k1: float = 0.01, k2: float = 0.03,
                  dynamic_range: float = 255.0) -> float:
    """SSIM the way the reference scores it (SSIM_PIL.compare_ssim).

    a, b: float images in [0, 1], [H, W] or [H, W, C]; quantised to uint8 as
    FISRnet.py:890 does (`(img * 255).astype('uint8')`: truncation, not
    rounding). Crop to tile_size multiples, split into non-overlapping tiles,
    per-tile mean, variance and covariance over a uniform window pooling all
    bands, per-tile SSIM with C1=(k1*L)^2, C2=(k2*L)^2, mean over tiles.
    """
    a8 = (np.asarray(a) * 255.0).astype(np.uint8).astype(np.float64)
    b8 = (np.asarray(b) * 255.0).astype(np.uint8).astype(np.float64)
    if a8.ndim == 2:
        a8, b8 = a8[..., None], b8[..., None]
    h, w, c = a8.shape
    th, tw = (h // tile_size) * tile_size, (w // tile_size) * tile_size

    def tiles(x):  # [n_tiles, tile_px * bands]
        x = x[:th, :tw].reshape(th // tile_size, tile_size, tw // tile_size, tile_size, c)
        return x.transpose(0, 2, 1, 3, 4).reshape(-1, tile_size * tile_size * c)

    a_t, b_t = tiles(a8), tiles(b8)
    mu_a = a_t.mean(axis=1)
    mu_b = b_t.mean(axis=1)
    var_a = a_t.var(axis=1)  # population (ddof=0), like ImageStat
    var_b = b_t.var(axis=1)
    cov = ((a_t - mu_a[:, None]) * (b_t - mu_b[:, None])).mean(axis=1)
    c1 = (k1 * dynamic_range) ** 2
    c2 = (k2 * dynamic_range) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(s.mean())
