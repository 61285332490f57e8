"""The 7-term multi-scale temporal loss of FISR (port of
fisr_tpu/train/losses.py).

Parity with FISRnet.py:312-486. All terms are evaluated at the model's three
output scales with weights 1 (l3, full) / 2 (l2) / 4 (l1), using `L2 = mean
of squared error` (ops.py:30-32):

stride-1 terms (over the 3 sliding-window predictions, 9 frames):
  1. reconstruction (Eq. 6)      - window i vs GT frames [2i, 2i+3)
  2. temporal matching (Eq. 1)   - the two overlapped frames of adjacent
                                   windows must agree
  3. temporal matching mean (Eq. 3) - their average must match the GT frame
  4. temporal difference (Eq. 4) - frame-to-frame differences of the
                                   overlap-merged 7-frame sequence vs GT

stride-2 terms (one window over frames {0, 2, 4}):
  5. reconstruction (Eq. 7)      - vs GT frames {1, 3, 5}
  6. temporal difference (Eq. 5)
  7. temporal matching (Eq. 2)   - vs the stride-1 merged predictions at
                                   the same timestamps (the gradient flows
                                   into both branches, as in the reference:
                                   nothing is detached)

Default lambdas (main.py:80-85): recn 1.0, tm1 1.0, tm2 0.1, tmm 1.0,
td 0.1, ss2 1.0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from fisr_tpu_torch.ops.seq import groups_to_overlap

SCALE_WEIGHTS = (1.0, 2.0, 4.0)  # (l3, l2, l1), FISRnet.py:326-328

__all__ = ["LossWeights", "temporal_loss", "l2_loss"]


@dataclasses.dataclass(frozen=True)
class LossWeights:
    recn: float = 1.0
    tm1: float = 1.0
    tm2: float = 0.1
    tmm: float = 1.0
    td: float = 0.1
    ss2: float = 1.0


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def _multi_scale(term_fn, preds_by_scale, gts_by_scale) -> torch.Tensor:
    """Apply `term_fn(pred, gt)` at (l3, l2, l1) with weights (1, 2, 4)."""
    total = 0.0
    for w, p, g in zip(SCALE_WEIGHTS, preds_by_scale, gts_by_scale):
        total = total + w * term_fn(p, g)
    return total


def _recn(pred_groups, gt):  # Eq. 6
    loss = 0.0
    for i in range(3):
        loss = loss + l2_loss(pred_groups[:, 3 * i : 3 * i + 3], gt[:, 2 * i : 2 * i + 3])
    return loss


def _tm1(pred_groups, _gt):  # Eq. 1
    loss = 0.0
    for i in range(2):
        loss = loss + l2_loss(pred_groups[:, 3 * i + 2], pred_groups[:, 3 * i + 3])
    return loss


def _tmm(pred_groups, gt):  # Eq. 3
    loss = 0.0
    for i in range(2):
        avg = (pred_groups[:, 3 * i + 2] + pred_groups[:, 3 * i + 3]) * 0.5
        loss = loss + l2_loss(avg, gt[:, 2 * (i + 1)])
    return loss


def _td(ovlp, gt):  # Eq. 4
    loss = 0.0
    for i in range(6):
        loss = loss + l2_loss(ovlp[:, i + 1] - ovlp[:, i], gt[:, i + 1] - gt[:, i])
    return loss


def _td_ss2(pred_ss2, gt_ss2):  # Eq. 5
    loss = 0.0
    for i in range(2):
        loss = loss + l2_loss(
            pred_ss2[:, i + 1] - pred_ss2[:, i], gt_ss2[:, i + 1] - gt_ss2[:, i]
        )
    return loss


def _recn_ss2(pred_ss2, gt_ss2):  # Eq. 7: one L2 over the 3-frame stack
    return l2_loss(pred_ss2, gt_ss2)


def temporal_loss(
    pred_groups: Sequence[torch.Tensor],
    pred_ss2: Sequence[torch.Tensor],
    gt: Sequence[torch.Tensor],
    weights: LossWeights = LossWeights(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full training loss.

    Args (each a 3-tuple (l3, l2, l1) of 5-dim [B, S, h, w, 3] tensors, cast
    to f32 here):
      pred_groups: stride-1 window predictions, S=9
      pred_ss2:    stride-2 prediction, S=3
      gt:          ground-truth sequences, S=7
    Returns (total_loss, metrics dict of unweighted terms + totals).
    """
    pred_groups = [p.float() for p in pred_groups]
    pred_ss2 = [p.float() for p in pred_ss2]
    gt = [g.float() for g in gt]
    ovlp = [groups_to_overlap(p) for p in pred_groups]

    recn = _multi_scale(_recn, pred_groups, gt)
    tm = _multi_scale(_tm1, pred_groups, gt)
    tmm = _multi_scale(_tmm, pred_groups, gt)
    td = _multi_scale(_td, ovlp, gt)
    total_s1 = weights.recn * recn + weights.tm1 * tm + weights.tmm * tmm + weights.td * td

    gt_ss2 = [g[:, 1::2] for g in gt]  # frames {1, 3, 5} (FISRnet.py:412-423)
    ovlp_ss2 = [o[:, 1::2] for o in ovlp]  # stride-1 preds at those timestamps
    recn_ss2 = _multi_scale(_recn_ss2, pred_ss2, gt_ss2)
    td_ss2 = _multi_scale(_td_ss2, pred_ss2, gt_ss2)
    tm_ss2 = _multi_scale(l2_loss, pred_ss2, ovlp_ss2)
    total_ss2 = weights.recn * recn_ss2 + weights.td * td_ss2 + weights.tm2 * tm_ss2

    total = total_s1 + weights.ss2 * total_ss2
    metrics = {
        "recnLoss": recn,
        "tmLoss": tm,
        "tmmLoss": tmm,
        "tdLoss": td,
        "totalLoss_s1": total_s1,
        "recnLoss_ss2": recn_ss2,
        "tdLoss_ss2": td_ss2,
        "tmLoss_ss2": tm_ss2,
        "totalLoss_ss2": total_ss2,
        "total_loss": total,
    }
    return total, metrics
