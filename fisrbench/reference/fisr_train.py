"""The reference's FISRnet training step in plain float32 (Kim, Oh and Kim,
"FISR", AAAI 2020, arXiv:1912.07213; JihyongOh/FISR `main.py --phase train`,
FISRnet.py:281-491): the four window rows of a sample, the three level
outputs, the ground-truth pyramid, the seven loss terms of the multi-scale
temporal loss with the lambdas of main.py:80-85, the backward by autograd
and tf.train.AdamOptimizer (reference/train.Adam).

A sample is the store's six arrays, sequence merged into channels: data
[H, W, 15] (5 LR frames), label [2H, 2W, 21] (7 HR frames), flow [H, W, 16]
(per adjacent pair forward then backward), warp [H, W, 24] (per pair its two
middle-frame warps), flow_ss2 [H, W, 8] and warp_ss2 [H, W, 12] (the pairs
(0, 2) and (2, 4)). Window i of the three stride-1 windows reads frames i..i+2
with their pairs' flows and warps (FISRnet.py:281-306); the stride-2 window
frames 0, 2, 4 with the stride-2 flows and warps (:394-406). Every row has 29
channels.

Loss (FISRnet.py:312-486), L2 the mean of squared differences, each term
summed over the scales (l3, l2, l1) with weights (1, 2, 4):
  recn   (Eq. 6) window i's 3 frames against GT frames 2i..2i+2;
  tm     (Eq. 1) the last frame of window i against the first of window i+1;
  tmm    (Eq. 3) their mean against GT frame 2(i+1);
  td     (Eq. 4) frame-to-frame differences of the merged 7-frame sequence
         (the overlapping frames averaged) against GT's;
  recn_ss2 (Eq. 7) the stride-2 window against GT frames 1, 3, 5;
  td_ss2 (Eq. 5) its frame-to-frame differences against theirs;
  tm_ss2 (Eq. 2) the stride-2 window against the merged sequence at 1, 3, 5.
total_s1 = recn + tm1 tm + tmm tmm + td td; total_ss2 = recn recn_ss2 +
td td_ss2 + tm2 tm_ss2; total = total_s1 + ss2 total_ss2.

The ground-truth pyramid is tf.image.resize_images(BICUBIC) of the label at
/2 and /4 (FISRnet.py:263-264). Under TF1's legacy transform (in = out *
factor, no half-pixel offset) an integer factor samples at whole input pixels,
where the Keys kernel's four taps are (0, 1, 0, 0): exactly subsampling, as
here. No departure.

Departures from FISRnet.py:
* the four rows of a batch go through one set of weights as one batch of
  4B rows, where the reference builds four weight-shared graphs: the same
  function;
* weights are glorot-normal kernels and zero biases from a seed, not TF's
  initialisers; data are the benchmark's synthetic scenes, not the .mat
  corpus;
* Adam runs at the stair schedule's first rate: the steps compared lie far
  before its first boundary (epoch 80);
* no PSNR and no summaries: only what the loss and its gradient need.
"""

from __future__ import annotations

import torch

from fisrbench.reference.fisrnet import FISRnetRef
from fisrbench.reference.train import Adam

SCALE_WEIGHTS = (1.0, 2.0, 4.0)  # (l3, l2, l1)
# input channels of a row, by kind, and of the previous level's prediction
# (levels 2 and 3): the first convolution's weight [out, in, 3, 3] of each
# level reads them in this order
INPUT_KINDS = {"frames": slice(0, 9), "flows": slice(9, 17), "warps": slice(17, 29),
               "prediction": slice(29, 38)}
FIRST_CONVS = tuple(f"level_{i}.enc.level_0.conv_in.weight" for i in (1, 2, 3))
TERMS = ("recnLoss", "tmLoss", "tmmLoss", "tdLoss", "totalLoss_s1", "recnLoss_ss2",
         "tdLoss_ss2", "tmLoss_ss2", "totalLoss_ss2", "total_loss")


def level_outputs(net: FISRnetRef, img):
    """img [R, H, W, 29] -> the three levels' predictions (l1, l2, l3) at
    (H/2, H, 2H), chained as FISRnetRef.__call__ chains them."""
    p1 = net.level("level_1", img[:, ::4, ::4, :])
    p2 = net.level("level_2", torch.cat([img[:, ::2, ::2, :], p1], dim=-1))
    p3 = net.level("level_3", torch.cat([img, p2], dim=-1))
    return p1, p2, p3


def window_rows(batch: dict):
    """The 4B rows [4B, H, W, 29]: windows 0, 1, 2, then the stride-2 window."""
    d, f, w = batch["data"], batch["flow"], batch["warp"]
    rows = [torch.cat([d[..., 3 * i:3 * i + 9], f[..., 4 * i:4 * i + 8],
                       w[..., 6 * i:6 * i + 12]], dim=-1) for i in range(3)]
    ss2 = torch.cat([d[..., 0:3], d[..., 6:9], d[..., 12:15], batch["flow_ss2"],
                     batch["warp_ss2"]], dim=-1)
    return torch.cat(rows + [ss2], dim=0)


def frames(x):
    """[N, h, w, 3S] -> [N, S, h, w, 3]."""
    n, h, w, c = x.shape
    return x.reshape(n, h, w, c // 3, 3).permute(0, 3, 1, 2, 4)


def gt_pyramid(label):
    """label [B, 2H, 2W, 21] -> GT frames [B, 7, ., ., 3] at (l3, l2, l1)."""
    return tuple(frames(label[:, ::f, ::f, :]) for f in (1, 2, 4))


def merged(groups):
    """[B, 9, ...] of three windows -> the 7-frame sequence, the two
    overlapping frames averaged."""
    g = groups
    return torch.stack([g[:, 0], g[:, 1], (g[:, 2] + g[:, 3]) * 0.5, g[:, 4],
                        (g[:, 5] + g[:, 6]) * 0.5, g[:, 7], g[:, 8]], dim=1)


def _l2(a, b):
    return torch.mean(torch.square(a - b))


def _terms_at_scale(groups, ss2, gt):
    """The seven unweighted terms at one scale: groups [B, 9, ...], ss2 [B,
    3, ...], gt [B, 7, ...]."""
    seq = merged(groups)
    gt_ss2 = gt[:, 1::2]
    return {
        "recnLoss": sum(_l2(groups[:, 3 * i:3 * i + 3], gt[:, 2 * i:2 * i + 3])
                        for i in range(3)),
        "tmLoss": sum(_l2(groups[:, 3 * i + 2], groups[:, 3 * i + 3]) for i in range(2)),
        "tmmLoss": sum(_l2((groups[:, 3 * i + 2] + groups[:, 3 * i + 3]) * 0.5, gt[:, 2 * i + 2])
                       for i in range(2)),
        "tdLoss": sum(_l2(seq[:, i + 1] - seq[:, i], gt[:, i + 1] - gt[:, i]) for i in range(6)),
        "recnLoss_ss2": _l2(ss2, gt_ss2),
        "tdLoss_ss2": sum(_l2(ss2[:, i + 1] - ss2[:, i], gt_ss2[:, i + 1] - gt_ss2[:, i])
                          for i in range(2)),
        "tmLoss_ss2": _l2(ss2, seq[:, 1::2]),
    }


def temporal_loss(preds, label, lambdas: dict):
    """preds: the level outputs (l1, l2, l3) over the 4B rows; label the
    batch's. Returns {term: tensor} for the ten names of TERMS."""
    b = label.shape[0]
    gts = gt_pyramid(label)
    out = {}
    for weight, pred, gt in zip(SCALE_WEIGHTS, preds[::-1], gts):
        f = frames(pred)  # [4B, 3, ...]
        groups = torch.cat([f[i * b:(i + 1) * b] for i in range(3)], dim=1)
        for k, v in _terms_at_scale(groups, f[3 * b:], gt).items():
            out[k] = out.get(k, 0.0) + weight * v
    out.update(compose(out, lambdas))
    return {k: out[k] for k in TERMS}


def compose(terms: dict, lam: dict) -> dict:
    """The subtotals and the total from the seven weighted terms."""
    s1 = (lam["recn"] * terms["recnLoss"] + lam["tm1"] * terms["tmLoss"]
          + lam["tmm"] * terms["tmmLoss"] + lam["td"] * terms["tdLoss"])
    s2 = (lam["recn"] * terms["recnLoss_ss2"] + lam["td"] * terms["tdLoss_ss2"]
          + lam["tm2"] * terms["tmLoss_ss2"])
    return {"totalLoss_s1": s1, "totalLoss_ss2": s2, "total_loss": s1 + lam["ss2"] * s2}


def train_steps(params: dict, sf: int, batches, lr: float, lambdas: dict, numerics=None):
    """Run len(batches) reference steps from `params` (updated in place).
    Returns ([{term: float} a step], the first step's gradients {name:
    tensor})."""
    for p in params.values():
        p.requires_grad_(True)
    net = FISRnetRef(params, sf, numerics)
    opt = Adam(params, lr)
    names = list(params)
    dev = next(iter(params.values())).device
    steps, first = [], None
    for batch in batches:
        batch = {k: v.to(dev) for k, v in batch.items()}
        terms = temporal_loss(level_outputs(net, window_rows(batch)), batch["label"], lambdas)
        grads = dict(zip(names, torch.autograd.grad(terms["total_loss"],
                                                    [params[k] for k in names])))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        steps.append({k: float(v.detach()) for k, v in terms.items()})
        opt.step(params, grads)
        del terms, grads
    for p in params.values():
        p.requires_grad_(False)
    return steps, first
