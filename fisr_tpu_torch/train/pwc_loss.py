"""PWC-Net training losses + EPE metric (port of fisr_tpu/train/pwc_loss.py).

The equivalent of upstream tfoptflow's `losses.pwcnet_loss`
(model_pwcnet.py:23,296,518 call sites; option hyper-params at :75-79):

* multiscale - per pyramid level l (top level 6 first, matching the model's
  flow_pyr order), alpha_l * mean-over-batch of the summed L2 norm between
  the level's predicted flow and the GT flow bilinearly resized to the
  level's resolution and divided by the SPATIAL DOWNSCALE RATIO (2^l), i.e.
  pyramid flows are supervised in level-pixel units. Evidence for the
  convention: the reference converts its level-2 flow to full-res pixels
  with `* 2**flow_pred_lvl` (model_pwcnet.py:1586-1590), which is only
  unit-correct under per-level-pixel supervision (upstream tfoptflow
  losses.py scales gt by gt_height/lvl_height the same way);
* robust     - same structure with (|dx|+|dy| + epsilon)^q instead of the
  L2 norm (used for fine-tuning);
* plus the gamma * L2 weight-decay term the reference adds via
  tf.losses.get_regularization_loss, over every parameter, biases too.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from fisr_tpu_torch.ops.resize import resize_tf1

ALPHAS = (0.32, 0.08, 0.02, 0.01, 0.005, 0.0025)  # levels 6..1 (paper)

__all__ = ["pwcnet_loss", "epe"]


def _level_gt(y: torch.Tensor, hw) -> torch.Tensor:
    # gt in level-pixel units: downscale values by the spatial ratio
    # (upstream losses.py: scaled_flow_gt /= gt_height / lvl_height)
    return resize_tf1(y, hw, "bilinear") * (float(hw[0]) / float(y.shape[1]))


def pwcnet_loss(
    y: torch.Tensor,
    flow_pyr: Sequence[torch.Tensor],
    params: Optional[Iterable[torch.Tensor]] = None,
    mode: str = "multiscale",
    alphas: Sequence[float] = ALPHAS,
    epsilon: float = 0.01,
    q: float = 0.4,
    gamma: float = 0.0004,
) -> torch.Tensor:
    """y: GT flow [B, H, W, 2] (full res); flow_pyr: model outputs, coarsest
    (level 6) first; params: the tensors under weight decay (a model's
    `parameters()`) or None."""
    total = 0.0
    for alpha, flow in zip(alphas, flow_pyr):
        gt = _level_gt(y.float(), flow.shape[1:3])
        diff = flow.float() - gt
        if mode == "multiscale":
            # the 1e-16 keeps the gradient finite where the error is zero
            norm = torch.sqrt(torch.sum(torch.square(diff), dim=-1) + 1e-16)
        elif mode == "robust":
            norm = torch.pow(torch.sum(torch.abs(diff), dim=-1) + epsilon, q)
        else:
            raise ValueError(mode)
        total = total + alpha * torch.mean(torch.sum(norm, dim=(1, 2)))
    if params is not None and gamma:
        # reference: gamma * sum(tf.nn.l2_loss(var)) and l2_loss = sum(v^2)/2
        # (model_pwcnet.py:524): keep the /2 so gamma means the same thing
        wsum = sum(torch.sum(torch.square(p)) for p in params)
        total = total + gamma * 0.5 * wsum
    return total


def epe(flow_pred: torch.Tensor, flow_gt: torch.Tensor) -> torch.Tensor:
    """Average end-point error (the reference's val ranking metric)."""
    d = flow_pred.float() - flow_gt.float()
    return torch.mean(torch.sqrt(torch.sum(torch.square(d), dim=-1)))
