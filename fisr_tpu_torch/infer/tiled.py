"""Patch-tiled high-resolution inference, host-staged (port of
fisr_tpu/infer/tiled.py).

The reference tiles 4K frames into a `test_patch` grid with a 32-px halo
(FISRnet.py:846-880). Here the same tiling is a handful of batched applies:

* `get_hw_boundary` / `trim_patch_boundary`: the reference's asymmetric halo
  arithmetic (utils.py:118-159). Interior patch sides carry a `boundary`
  halo, frame-edge sides carry none, and the model's output is trimmed by
  boundary*sf wherever a halo existed.
* mode `exact` reproduces the reference's patch shapes: patches are grouped
  by their (add_h, add_w) halo signature (at most 4 shapes for any grid) and
  each group is uploaded and applied as one batch.
* mode `padded` zero-pads the split axes by `boundary`, so every patch has
  one shape and the whole grid is one apply. Interior patches equal `exact`;
  frame-edge pixels differ within the receptive field (the class of
  approximation tiling itself makes). infer/device.tiled_apply is this
  tiling on the device.

The runner takes host numpy arrays and returns host numpy arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fisr_tpu_torch.device import resolve_device
from fisr_tpu_torch.models import fisrnet
from fisr_tpu_torch.ops.conv import F32, Policy

__all__ = ["get_hw_boundary", "trim_patch_boundary", "TiledRunner"]


def get_hw_boundary(patch_boundary: int, h: int, w: int, p_h: int, s_h: int,
                    p_w: int, s_w: int):
    """Reference utils.py:118-135: the patch's crop and its halo extents."""
    h_low = max(p_h * s_h - patch_boundary, 0)
    h_high = min((p_h + 1) * s_h + patch_boundary, h)
    w_low = max(p_w * s_w - patch_boundary, 0)
    w_high = min((p_w + 1) * s_w + patch_boundary, w)
    add_h = 0
    add_w = 0
    if p_h * s_h >= patch_boundary:
        add_h += patch_boundary
    if (p_h + 1) * s_h + patch_boundary <= h:
        add_h += patch_boundary
    if p_w * s_w >= patch_boundary:
        add_w += patch_boundary
    if (p_w + 1) * s_w + patch_boundary <= w:
        add_w += patch_boundary
    return h_low, h_high, w_low, w_high, add_h, add_w


def trim_patch_boundary(img: np.ndarray, patch_boundary: int, h: int, w: int,
                        p_h: int, s_h: int, p_w: int, s_w: int, sf: int):
    """Reference utils.py:138-159 (img: [B, H', W', C])."""
    if patch_boundary == 0:
        return img
    if p_h * s_h >= patch_boundary:
        img = img[:, patch_boundary * sf:, :, :]
    if (p_h + 1) * s_h + patch_boundary <= h:
        img = img[:, :-patch_boundary * sf or None, :, :]
    if p_w * s_w >= patch_boundary:
        img = img[:, :, patch_boundary * sf:, :]
    if (p_w + 1) * s_w + patch_boundary <= w:
        img = img[:, :, :-patch_boundary * sf or None, :]
    return img


class TiledRunner:
    """Patch-tiled FISRnet level-3 inference over full frames.

    model:    FISRnet (moved to `device`)
    grid:     (rows, cols) patch grid, the reference's `test_patch`
    boundary: halo width in input pixels (32, FISRnet.py:779)
    sf:       spatial upscale factor (2)
    mode:     'exact' | 'padded'
    """

    def __init__(self, model: fisrnet.FISRnet, grid: Tuple[int, int] = (2, 2),
                 boundary: int = 32, sf: int = 2, policy: Policy = F32,
                 mode: str = "exact", device="cuda"):
        if mode not in ("exact", "padded"):
            raise ValueError(f"mode {mode!r}: want 'exact' or 'padded'")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.grid = tuple(grid)
        self.boundary = boundary
        self.sf = sf
        self.policy = policy
        self.mode = mode

    @torch.no_grad()
    def _apply(self, stack: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(stack, np.float32)).to(self.device)
        return fisrnet.apply(self.model, x, self.sf, self.policy)[2].float().cpu().numpy()

    def __call__(self, inp: np.ndarray) -> np.ndarray:
        """inp: [B, h, w, 29] host array (h, w multiples of 32*grid).
        Returns [B, h*sf, w*sf, 9] float32 host array."""
        _b, h, w, _c = inp.shape
        gh, gw = self.grid
        s_h, s_w = h // gh, w // gw
        # an interior patch whose low halo clips at the frame edge would break
        # the equal-shape grouping; the reference never gets there (its crop
        # guarantees s >= 32, FISRnet.py:818-825), so fail clearly
        if (gh > 1 and s_h < self.boundary) or (gw > 1 and s_w < self.boundary):
            raise ValueError(
                f"patch side ({s_h}x{s_w} from grid {self.grid} on {h}x{w}) must be "
                f">= boundary ({self.boundary}); use a coarser grid or a smaller boundary")
        return self._run_padded(inp) if self.mode == "padded" else self._run_exact(inp)

    def _run_exact(self, inp: np.ndarray) -> np.ndarray:
        b, h, w, _c = inp.shape
        gh, gw = self.grid
        s_h, s_w = h // gh, w // gw
        sf = self.sf
        out = np.zeros((b, h * sf, w * sf, 9), np.float32)
        groups: dict = {}
        for p_h in range(gh):
            for p_w in range(gw):
                hl, hh, wl, wh, add_h, add_w = get_hw_boundary(
                    self.boundary, h, w, p_h, s_h, p_w, s_w)
                groups.setdefault((add_h, add_w), []).append((p_h, p_w, hl, hh, wl, wh))
        for patches in groups.values():
            stack = np.concatenate([inp[:, hl:hh, wl:wh, :]
                                    for (_, _, hl, hh, wl, wh) in patches], 0)
            pred = self._apply(stack)
            for i, (p_h, p_w, *_rest) in enumerate(patches):
                trimmed = trim_patch_boundary(pred[i * b:(i + 1) * b], self.boundary, h, w,
                                              p_h, s_h, p_w, s_w, sf)
                out[:, p_h * s_h * sf:(p_h + 1) * s_h * sf,
                    p_w * s_w * sf:(p_w + 1) * s_w * sf, :] = trimmed
        return out

    def _run_padded(self, inp: np.ndarray) -> np.ndarray:
        b, h, w, _c = inp.shape
        gh, gw = self.grid
        s_h, s_w = h // gh, w // gw
        sf = self.sf
        # zero-pad only the axes the grid splits: an unsplit axis keeps the
        # model's own SAME behaviour at the frame edge
        bh = self.boundary if gh > 1 else 0
        bw = self.boundary if gw > 1 else 0
        padded = np.pad(inp, ((0, 0), (bh, bh), (bw, bw), (0, 0)))
        stack = np.concatenate(
            [padded[:, p_h * s_h:(p_h + 1) * s_h + 2 * bh, p_w * s_w:(p_w + 1) * s_w + 2 * bw, :]
             for p_h in range(gh) for p_w in range(gw)], 0)
        pred = self._apply(stack)
        th, tw = bh * sf, bw * sf
        out = np.zeros((b, h * sf, w * sf, 9), np.float32)
        k = 0
        for p_h in range(gh):
            for p_w in range(gw):
                out[:, p_h * s_h * sf:(p_h + 1) * s_h * sf,
                    p_w * s_w * sf:(p_w + 1) * s_w * sf, :] = pred[
                        k * b:(k + 1) * b, th:th + s_h * sf, tw:tw + s_w * sf, :]
                k += 1
        return out
