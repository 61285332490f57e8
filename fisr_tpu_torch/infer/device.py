"""Device-resident FISRnet runners (port of fisr_tpu/infer/device.py): patch
extraction, the model, trimming and reassembly all on tensors that stay on
the device.

* full   - no tiling: one FISRnet apply on the whole frame.
* tiled  - the `padded` tiling of infer/tiled.py on the device (zero-pad the
  split axes, batch the patch grid, trim, reassemble), with the stale-halo
  shrink and the folded upsample of level 3.
* staged - each level tiled at its own grid.

The grids that `padded_grid`, `best_grid` and `default_plans` choose are the
plan of the JAX package, which tuned them for its own hardware. The port
keeps them because the plan decides the numerics: `'auto'` must give the JAX
package's output. Which plan is fastest on a CUDA card is measured by
`chip_smoke.py` (phase `tiled`) and recorded in PERF.md.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fisr_tpu_torch.device import resolve_device
from fisr_tpu_torch.models import fisrnet
from fisr_tpu_torch.ops.conv import F32, Policy
from fisr_tpu_torch.ops.resize import downsample_int

__all__ = ["make_device_runner", "staged_apply", "run_level_tiled", "default_plans",
           "tiled_apply", "tiled_apply_padded", "padded_grid", "best_grid",
           "FastTiledRunner"]


def _split(x: torch.Tensor, grid, halo_h: int, halo_w: int) -> torch.Tensor:
    """Overlapping patchify: zero-pad the canvas, batch the (gh, gw) grid,
    patch-major and batch-minor."""
    gh, gw = grid
    _b, h, w, _c = x.shape
    if h % gh or w % gw:
        raise ValueError(f"grid {tuple(grid)} does not divide frame {h}x{w}: reassembly "
                         f"would drop up to {gh - 1}/{gw - 1} rows/cols")
    sh, sw = h // gh, w // gw
    xp = F.pad(x, (0, 0, halo_w, halo_w, halo_h, halo_h))
    return torch.cat([xp[:, i * sh:(i + 1) * sh + 2 * halo_h, j * sw:(j + 1) * sw + 2 * halo_w, :]
                      for i in range(gh) for j in range(gw)], 0)


def _unpatchify(y: torch.Tensor, grid: Tuple[int, int], b: int) -> torch.Tensor:
    """Inverse of `_split` on the patch cores: [gh*gw*B, sh, sw, C] ->
    [B, gh*sh, gw*sw, C]."""
    gh, gw = grid
    _, sh, sw, c = y.shape
    t = y.reshape(gh, gw, b, sh, sw, c)
    return t.permute(2, 0, 3, 1, 4, 5).reshape(b, gh * sh, gw * sw, c)


def _stale(halo_h: int, halo_w: int, halo: int) -> int:
    """The ring the model may shrink: `halo` when both axes carry it and it
    fits fisrnet.apply_level's rule, else 0."""
    ok = halo_h == halo_w == halo and halo >= 16 and (halo - 16) % 8 == 0
    return halo if ok else 0


def run_level_tiled(p: fisrnet.Level, x: torch.Tensor, grid, halo: int, sf: int = 2,
                    policy: Policy = F32) -> torch.Tensor:
    """One FISRnet level, patch-tiled at `grid` with a ring of `halo` px.

    Full frame in, full frame out. The halos are declared stale to the model,
    which shrinks them on the way (fisrnet.apply_level) when both axes are
    split. Grid (1, 1) is the plain full-frame apply.
    """
    gh, gw = grid
    if gh * gw == 1:
        return fisrnet.apply_level(p, x, sf, policy)
    b = x.shape[0]
    hh = halo if gh > 1 else 0
    hw = halo if gw > 1 else 0
    stale = _stale(hh, hw, halo)
    pred = fisrnet.apply_level(p, _split(policy.cast(x), grid, hh, hw), sf, policy,
                               stale_halo=stale, fast_upsample=True)
    th = (fisrnet._TAIL_HEADS if stale else hh) * sf
    tw = (fisrnet._TAIL_HEADS if stale else hw) * sf
    core = pred[:, th:pred.shape[1] - th, tw:pred.shape[2] - tw, :]
    return _unpatchify(core, grid, b)


def default_plans(h: int, w: int):
    """Per-level patch grids for an (h, w) input window (the JAX package's
    plan: the finest level gets up to (4, 4) patches of at least 256 px a
    side, level 2 up to (2, 2), level 1 runs whole)."""
    def g(scale, target):
        def pick(extent, tgt):
            # largest grid <= tgt that divides the extent
            want = max(1, min(tgt, extent // 256))
            return max(d for d in range(1, want + 1) if extent % d == 0)
        return (pick(h // scale, target), pick(w // scale, target))
    return {"level_1": (1, 1), "level_2": g(2, 2), "level_3": g(1, 4)}


def staged_apply(model: fisrnet.FISRnet, img: torch.Tensor, plans=None, boundary: int = 32,
                 sf: int = 2, policy: Policy = F32):
    """Full 3-level FISRnet with each level tiled on its own (run_level_tiled).

    Each level is tiled at its own grid with the reference halo at its own
    scale (boundary/4, /2, /1); the levels hand over full-frame tensors. Same
    outputs as `fisrnet.apply`; `plans` maps level name -> patch grid.
    """
    if plans is None:
        plans = default_plans(img.shape[1], img.shape[2])
    img = policy.cast(img)
    pred_l1 = run_level_tiled(model.level_1, downsample_int(img, 4), plans["level_1"],
                              boundary // 4, sf, policy)
    img_l2 = torch.cat([downsample_int(img, 2), pred_l1], dim=-1)
    pred_l2 = run_level_tiled(model.level_2, img_l2, plans["level_2"], boundary // 2, sf, policy)
    img_l3 = torch.cat([img, pred_l2], dim=-1)
    pred_l3 = run_level_tiled(model.level_3, img_l3, plans["level_3"], boundary, sf, policy)
    return pred_l1, pred_l2, pred_l3


def tiled_apply(model: fisrnet.FISRnet, x: torch.Tensor, grid: Tuple[int, int],
                boundary: int = 32, sf: int = 2, policy: Policy = F32) -> torch.Tensor:
    """Padded tiling on the device (the runners' and the fused video path's).

    Zero-pads only the axes the grid splits, batches the patch grid into one
    FISRnet apply with level 3's folded upsample, trims and reassembles. When
    both axes are split the halo is declared stale (final_stale_halo) and the
    model shrinks it once the remaining stages stop reading it.
    """
    gh, gw = grid
    b, h, w, _c = x.shape
    if h % gh or w % gw:
        raise ValueError(f"grid {tuple(grid)} does not divide frame {h}x{w}")
    s_h, s_w = h // gh, w // gw
    bh = boundary if gh > 1 else 0
    bw = boundary if gw > 1 else 0
    stale = _stale(bh, bw, boundary)
    pred = fisrnet.apply(model, _split(policy.cast(x), grid, bh, bw), sf, policy,
                         final_stale_halo=stale, fast_upsample=True)[2]
    th = (fisrnet._TAIL_HEADS if stale else bh) * sf
    tw = (fisrnet._TAIL_HEADS if stale else bw) * sf
    core = pred[:, th:th + s_h * sf, tw:tw + s_w * sf, :]
    return _unpatchify(core, grid, b)


def tiled_apply_padded(model: fisrnet.FISRnet, x: torch.Tensor, grid: Tuple[int, int],
                       pads: Tuple[int, int] = (0, 0), boundary: int = 32, sf: int = 2,
                       policy: Policy = F32) -> torch.Tensor:
    """`tiled_apply` behind an edge-replicated pad that unlocks `grid`.

    Pads rows and columns at the bottom and right in edge mode (replicated
    context is closer to the frame's interior than a zero ring), tiles at
    `grid` and crops the sf-scaled output back, so an extent that `grid` does
    not divide (1056 rows admit only gh in {1, 3}) can take it anyway (1152
    rows take 4). Equal to `tiled_apply` everywhere but in the bottom and
    right `boundary`-px band of the real frame, whose halo reads replicated
    rows instead of the zero ring.
    """
    ph, pw = pads
    if not (ph or pw):
        return tiled_apply(model, x, grid, boundary, sf, policy)
    _b, h, w, _c = x.shape
    # replicate-mode F.pad wants NCHW and a float type
    xp = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)
    y = tiled_apply(model, xp, grid, boundary, sf, policy)
    return y[:, :h * sf, :w * sf, :]


def padded_grid(h: int, w: int, target: Tuple[int, int] = (4, 6),
                max_pad_frac: float = 0.10):
    """((gh, gw), (pad_h, pad_w)): the largest grid <= target reachable by
    padding each axis by at most `max_pad_frac`, preferring less padding at
    an equal grid. With no pad admitted an axis lands on its largest dividing
    g, so the result then equals best_grid(h, w) with pad (0, 0).

    The target (4, 6) and the 10 % budget are the JAX package's: at 1056x1920
    they give (4, 6) with 96 pad rows, at 1024x1920 (4, 6) with no pad.
    """
    if h % 32 or w % 32:
        raise ValueError(f"padded_grid: frame {h}x{w} must be 32-multiples")

    def axis(extent: int, tgt: int):
        for g in range(tgt, 0, -1):
            pad = (-extent) % (32 * g)
            if pad <= max_pad_frac * extent:
                return g, pad
        return 1, 0

    (gh, ph), (gw, pw) = axis(h, target[0]), axis(w, target[1])
    return (gh, gw), (ph, pw)


def best_grid(h: int, w: int, target: Tuple[int, int] = (4, 6)):
    """Largest grid <= target whose patches stay 32-multiples (the JAX
    package's default target)."""
    if h % 32 or w % 32:
        # even grid 1 needs 32-multiples (FISRnet's /4 pyramid and the halo
        # arithmetic); callers crop first (run_video_pipeline: h - h % 32)
        raise ValueError(f"best_grid: frame {h}x{w} must be 32-multiples "
                         "(crop or pad first, e.g. 1080 -> 1056)")
    gh = max(g for g in range(1, target[0] + 1) if h % (32 * g) == 0)
    gw = max(g for g in range(1, target[1] + 1) if w % (32 * g) == 0)
    return gh, gw


class FastTiledRunner:
    """TiledRunner's interface over the device path.

    The same call contract as infer/tiled.TiledRunner (host numpy in and out,
    `.grid` and `.sf`, what infer/evaluate needs), but one `tiled_apply` a
    call: padded tiling, stale-halo shrink, level 3's folded upsample.
    `padded`-class quality (interior patches exact, zero-ring frame edges);
    the `exact` TiledRunner stays the default for published-number
    evaluation.
    """

    def __init__(self, model: fisrnet.FISRnet, grid: Tuple[int, int] = (2, 2),
                 boundary: int = 32, sf: int = 2, policy: Policy = F32, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.grid = tuple(grid)
        self.boundary = boundary
        self.sf = sf
        self.policy = policy

    @torch.no_grad()
    def __call__(self, inp: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(inp, np.float32)).to(self.device)
        out = tiled_apply(self.model, x, self.grid, self.boundary, self.sf, self.policy)
        return out.float().cpu().numpy()


def make_device_runner(mode: str = "full", grid: Tuple[int, int] = (2, 2),
                       boundary: int = 32, sf: int = 2, policy: Policy = F32):
    """fn(model, x [B, h, w, 29]) -> [B, h*sf, w*sf, 9], on x's device and
    without autograd. Modes 'full', 'staged', 'tiled'."""
    if mode == "full":
        def run(model, x):
            return fisrnet.apply(model, x, sf, policy)[2]
    elif mode == "staged":
        def run(model, x):
            return staged_apply(model, x, None, boundary, sf, policy)[2]
    elif mode == "tiled":
        def run(model, x):
            return tiled_apply(model, x, grid, boundary, sf, policy)
    else:
        raise ValueError(f"mode {mode!r}: want 'full', 'staged' or 'tiled'")
    return torch.no_grad()(run)
