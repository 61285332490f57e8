"""GT-based quality evaluation for the FISR_for_video phase (port of
fisr_tpu/infer/video_eval.py).

The reference's video phase has no metrics at all — it upconverts arbitrary
footage and saves PNGs (FISRnet.py:937-1084); only the `test` phase, which
needs precomputed flow/warp files, is scored (FISRnet.py:887-933). This
module closes that gap for scenes where high-frame-rate high-res ground
truth exists (e.g. the JAX package's
`data.synth.write_synthetic_video_scene`, or any real HFR/HR footage
downconverted the same way): it scores the pipeline's
written `pred_YUV_*.png` frames against GT frames of the same index, split
into the reference's two metric families —
  * SR frames (ODD output index: a 2x-upscaled input frame — window fr's
    middle output, half-step 2fr+2, lands at file index 2fr+1), and
  * VFI-SR frames (EVEN output index: an interpolated-and-upscaled frame)
— the same split the test phase reports (fr2 vs fr1/fr3,
FISRnet.py:913-933; see write_synthetic_video_scene's docstring for the
file-index <-> half-step derivation). PSNR on YUV in [0,1] (utils.py:161
`_compute_psnr` semantics) in numpy float64 + the package's Gaussian SSIM
(ops/metrics.ssim) on the device the caller names.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re

import numpy as np
import torch

from fisr_tpu_torch.device import resolve_device
from fisr_tpu_torch.native import decode_png
from fisr_tpu_torch.ops import metrics as M

__all__ = ["VideoEvalResult", "evaluate_video_folder"]


@dataclasses.dataclass
class VideoEvalResult:
    psnr_vfi_sr: float
    psnr_sr: float
    ssim_vfi_sr: float
    ssim_sr: float
    n_vfi_sr: int
    n_sr: int

    def as_dict(self) -> dict:
        return {k: round(v, 4) if isinstance(v, float) else v
                for k, v in dataclasses.asdict(self).items()}


def _indexed(folder: str, pattern: str) -> dict:
    out = {}
    for p in glob.glob(os.path.join(folder, pattern)):
        m = re.search(r"(\d+)\.png$", os.path.basename(p))
        if m:
            out[int(m.group(1))] = p
    return out


def evaluate_video_folder(pred_folder: str, gt_folder: str,
                          compute_ssim: bool = True, device="cuda") -> VideoEvalResult:
    """Score `pred_YUV_{k}.png` frames against GT `*_{k}.png` of the same
    index k (see `write_synthetic_video_scene` for why indices align). The
    Gaussian SSIM of each frame runs on `device`."""
    dev = resolve_device(device)
    preds = _indexed(pred_folder, "pred_YUV_*.png")
    gts = _indexed(gt_folder, "*.png")
    common = sorted(set(preds) & set(gts))
    if not common:
        raise ValueError(
            f"no index-aligned frames between {pred_folder} and {gt_folder}")

    psnr = {0: [], 1: []}  # parity of the output index: 1 = SR, 0 = VFI-SR
    ssim = {0: [], 1: []}
    for k in common:
        p = decode_png(preds[k]).astype(np.float64) / 255.0
        g = decode_png(gts[k]).astype(np.float64) / 255.0
        if p.shape != g.shape:
            raise ValueError(f"frame {k}: pred {p.shape} != gt {g.shape}")
        psnr[k % 2].append(M.psnr_np(g, p, 1.0))
        if compute_ssim:
            ssim[k % 2].append(float(M.ssim(
                torch.from_numpy(p.astype(np.float32)).to(dev),
                torch.from_numpy(g.astype(np.float32)).to(dev))))

    def mean(xs):
        return float(np.mean(xs)) if xs else float("nan")

    return VideoEvalResult(
        psnr_vfi_sr=mean(psnr[0]), psnr_sr=mean(psnr[1]),
        ssim_vfi_sr=mean(ssim[0]), ssim_sr=mean(ssim[1]),
        n_vfi_sr=len(psnr[0]), n_sr=len(psnr[1]),
    )
