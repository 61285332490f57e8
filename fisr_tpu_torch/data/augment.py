"""Optical-flow training augmentation (flow-label-consistent; copy of
fisr_tpu/data/augment.py, numpy only).

Rebuild of the tfoptflow Augmenter (augment.py:27-36 options, :56-125):
random horizontal/vertical flips (p=0.5 each), random translation (+/-5% of
size, p=0.5), and random scaling (95-105%, p=0.5), applied identically to
both frames AND transformed on the flow labels: a horizontal flip negates
u, a vertical flip negates v; translating frame 2 relative to frame 1 adds
the translation to the flow; scaling resizes the flow field spatially and
multiplies the vectors by the ratio (augment.py:113-122).

`scale_keep_size` is the equivalent of the upstream tfoptflow `utils.scale`
helper (imported at augment.py:22; that utils module is not vendored in the
reference): bilinear resize by `ratio` with half-pixel centers, then
center-crop (ratio > 1) or center zero-pad (ratio < 1) back to the input
size, so augmented samples keep their shape.

The draws and the work are apart: `plan_augment` draws one sample's
`AugmentPlan` from a seeded Generator (reference seed 1969), and
`apply_plan` carries it out with numpy. `augment_pair` is the two in turn,
the plain version. FlowDataset hands the plan to the host runtime's fused
pass (native/bindings.flow_sample, csrc/native.cc), which gives apply_plan's
bits on the host's cores.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["AugmentOptions", "AugmentPlan", "plan_augment", "apply_plan", "augment_pair",
           "scale_keep_size", "scaled_size"]


@dataclasses.dataclass
class AugmentOptions:
    fliplr: float = 0.5
    flipud: float = 0.5
    translate_prob: float = 0.5
    translate_frac: float = 0.05  # +/- fraction of H/W
    scale_prob: float = 0.5
    scale_frac: float = 0.05  # ratio drawn from [1-frac, 1+frac]
    seed: int = 1969


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel-center bilinear resize (cv2.resize INTER_LINEAR semantics)."""
    h, w = img.shape[:2]
    ys = np.clip((np.arange(out_h) + 0.5) * (h / out_h) - 0.5, 0, h - 1)
    xs = np.clip((np.arange(out_w) + 0.5) * (w / out_w) - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    im = img[..., None] if img.ndim == 2 else img
    out = (im[y0][:, x0] * (1 - wy) * (1 - wx) + im[y0][:, x1] * (1 - wy) * wx
           + im[y1][:, x0] * wy * (1 - wx) + im[y1][:, x1] * wy * wx)
    return out[..., 0] if img.ndim == 2 else out


def scaled_size(h: int, w: int, ratio: float) -> tuple:
    """The size an [h, w] image takes when resized by `ratio`."""
    return int(round(h * ratio)), int(round(w * ratio))


def scale_keep_size(img: np.ndarray, ratio: float) -> np.ndarray:
    """Resize by `ratio`, then center-crop / center-zero-pad to input size.

    The tfoptflow `utils.scale` equivalent used by the scale augmentation
    (reference augment.py:118-121). img: [H, W] or [H, W, C].
    """
    h, w = img.shape[:2]
    sh, sw = scaled_size(h, w, ratio)
    scaled = _resize_bilinear(img.astype(np.float64), sh, sw).astype(img.dtype)
    if ratio >= 1.0:
        y0, x0 = (sh - h) // 2, (sw - w) // 2
        return scaled[y0 : y0 + h, x0 : x0 + w]
    out = np.zeros(img.shape, img.dtype)
    y0, x0 = (h - sh) // 2, (w - sw) // 2
    out[y0 : y0 + sh, x0 : x0 + sw] = scaled
    return out


@dataclasses.dataclass(frozen=True)
class AugmentPlan:
    """One sample's augmentation, as drawn: flips; frame 2 shifted by
    `shift` (tx, ty) with zero fill and the flow offset by it, (0, 0) for
    none; a resize by `ratio` (to `scaled_size`) kept at the input size,
    None for none."""
    fliplr: bool = False
    flipud: bool = False
    shift: tuple = (0, 0)
    ratio: Optional[float] = None


def plan_augment(opts: AugmentOptions, rng: np.random.Generator, h: int,
                 w: int) -> AugmentPlan:
    """Draw the plan of one [h, w] sample from `rng`, in the order the
    reference's Augmenter draws (augment.py:56-125)."""
    fliplr = bool(rng.uniform() < opts.fliplr)
    flipud = bool(rng.uniform() < opts.flipud)
    shift = (0, 0)
    if rng.uniform() < opts.translate_prob:
        tx = int(rng.uniform(-opts.translate_frac, opts.translate_frac) * w)
        ty = int(rng.uniform(-opts.translate_frac, opts.translate_frac) * h)
        shift = (tx, ty)
    ratio = None
    if rng.uniform() < opts.scale_prob:
        ratio = float(rng.uniform(1.0 - opts.scale_frac, 1.0 + opts.scale_frac))
    return AugmentPlan(fliplr, flipud, shift, ratio)


def apply_plan(x: np.ndarray, y: np.ndarray, plan: AugmentPlan):
    """x: [2, H, W, 3] frame pair; y: [H, W, 2] flow (u, v). Returns new
    (x, y), augmented as `plan` says."""
    x = x.copy()
    y = y.copy()
    h, w = y.shape[:2]
    if plan.fliplr:
        x = x[:, :, ::-1]
        y = y[:, ::-1]
        y[..., 0] = -y[..., 0]
    if plan.flipud:
        x = x[:, ::-1]
        y = y[::-1]
        y[..., 1] = -y[..., 1]
    tx, ty = plan.shift
    if tx or ty:
        # shift frame 2 by (tx, ty) with ZERO fill at the exposed
        # borders — the exact semantics of the reference's
        # cv2.warpAffine(translation) call (augment.py:108-111, default
        # BORDER_CONSTANT 0); flow gains the same offset. Pinned
        # against the reference's own Augmenter in
        # tests/test_augment_oracle.py.
        x2 = np.zeros_like(x[1])
        ys = slice(max(ty, 0), h + min(ty, 0))
        xs = slice(max(tx, 0), w + min(tx, 0))
        ys_src = slice(max(-ty, 0), h + min(-ty, 0))
        xs_src = slice(max(-tx, 0), w + min(-tx, 0))
        x2[ys, xs] = x[1][ys_src, xs_src]
        x[1] = x2
        y = y + np.array([tx, ty], y.dtype)
    if plan.ratio is not None:
        ratio = plan.ratio
        # both frames + the flow field resize together; flow VECTORS scale
        # by the same ratio (reference augment.py:113-122)
        x = np.stack([scale_keep_size(x[0], ratio),
                      scale_keep_size(x[1], ratio)])
        y = scale_keep_size(y, ratio) * np.asarray(ratio, y.dtype)
    return x, y


def augment_pair(x: np.ndarray, y: np.ndarray, opts: AugmentOptions,
                 rng: np.random.Generator):
    """x: [2, H, W, 3] frame pair; y: [H, W, 2] flow (u, v). Returns new
    (x, y): `plan_augment` then `apply_plan`."""
    h, w = y.shape[:2]
    return apply_plan(x, y, plan_augment(opts, rng, h, w))
