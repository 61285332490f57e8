"""The reference's PWC-Net training step in plain float32 (tfoptflow's
`pwcnet-lg-6-2-multisteps-chairsthingsmix` recipe): the training crops and
augmentation (dataset_base crop_preproc, augment.py), the multiscale loss
with L2 weight decay (losses.py, model_pwcnet.py:518-524) and
tf.train.AdamOptimizer, worked out again from the raw pairs and flows.

The sample stream follows the data layer's documented order: the training
split is the first n - max(1, int(0.1 n)) samples; an epoch permutes it with
numpy's default_rng(epoch_seed) and cuts batches in order; each sample draws
from one default_rng(data_seed) its crop corner (row, then column), then
fliplr, flipud, translate (tx, ty) and scale, each under its probability.
"""

from __future__ import annotations

import numpy as np
import torch

from fisrbench.reference.ops import resize_bilinear
from fisrbench.reference.pwcnet import PWCNetRef

ALPHAS = (0.32, 0.08, 0.02, 0.01, 0.005, 0.0025)


# ---- data: crops and augmentation ----

def _resize_hp(img, out_h, out_w):
    """Half-pixel-centre bilinear resize in float64 (cv2.resize INTER_LINEAR)."""
    h, w = img.shape[:2]
    ys = np.clip((np.arange(out_h) + 0.5) * (h / out_h) - 0.5, 0, h - 1)
    xs = np.clip((np.arange(out_w) + 0.5) * (w / out_w) - 0.5, 0, w - 1)
    y0, x0 = np.floor(ys).astype(np.int64), np.floor(xs).astype(np.int64)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    return (img[y0][:, x0] * (1 - wy) * (1 - wx) + img[y0][:, x1] * (1 - wy) * wx
            + img[y1][:, x0] * wy * (1 - wx) + img[y1][:, x1] * wy * wx)


def _scale_keep(img, ratio):
    h, w = img.shape[:2]
    sh, sw = int(round(h * ratio)), int(round(w * ratio))
    scaled = _resize_hp(img.astype(np.float64), sh, sw).astype(img.dtype)
    if ratio >= 1.0:
        y0, x0 = (sh - h) // 2, (sw - w) // 2
        return scaled[y0:y0 + h, x0:x0 + w]
    out = np.zeros(img.shape, img.dtype)
    y0, x0 = (h - sh) // 2, (w - sw) // 2
    out[y0:y0 + sh, x0:x0 + sw] = scaled
    return out


def _augment(x, y, aug: dict, rng):
    x, y = x.copy(), y.copy()
    h, w = y.shape[:2]
    if rng.uniform() < aug["fliplr"]:
        x, y = x[:, :, ::-1], y[:, ::-1].copy()
        y[..., 0] = -y[..., 0]
    if rng.uniform() < aug["flipud"]:
        x, y = x[:, ::-1], y[::-1].copy()
        y[..., 1] = -y[..., 1]
    if rng.uniform() < aug["translate_prob"]:
        tx = int(rng.uniform(-aug["translate_frac"], aug["translate_frac"]) * w)
        ty = int(rng.uniform(-aug["translate_frac"], aug["translate_frac"]) * h)
        if tx or ty:
            x = x.copy()
            x2 = np.zeros_like(x[1])
            x2[max(ty, 0):h + min(ty, 0), max(tx, 0):w + min(tx, 0)] = \
                x[1][max(-ty, 0):h + min(-ty, 0), max(-tx, 0):w + min(-tx, 0)]
            x[1] = x2
            y = y + np.array([tx, ty], y.dtype)
    if rng.uniform() < aug["scale_prob"]:
        ratio = float(rng.uniform(1.0 - aug["scale_frac"], 1.0 + aug["scale_frac"]))
        x = np.stack([_scale_keep(x[0], ratio), _scale_keep(x[1], ratio)])
        y = _scale_keep(y, ratio) * np.asarray(ratio, y.dtype)
    return x, y


def training_batches(pairs, flows, crop_hw, aug: dict, data_seed: int, epoch_seed: int,
                     batch: int, n_batches: int):
    """The first `n_batches` training batches of an epoch: (x [B, 2, ch, cw, 3]
    in [0, 1], y [B, ch, cw, 2]) as float32 numpy arrays."""
    n = len(pairs)
    n_train = n - (max(1, int(n * 0.1)) if n > 1 else 0)
    order = np.random.default_rng(epoch_seed).permutation(np.arange(n_train))
    rng = np.random.default_rng(data_seed)
    ch, cw = crop_hw
    out = []
    for k in range(n_batches):
        xs, ys = [], []
        for j in order[k * batch:(k + 1) * batch]:
            x, y = pairs[j].astype(np.float32), flows[j]
            h, w = y.shape[:2]
            y0 = rng.integers(0, h - ch + 1)
            x0 = rng.integers(0, w - cw + 1)
            x, y = x[:, y0:y0 + ch, x0:x0 + cw], y[y0:y0 + ch, x0:x0 + cw]
            x, y = _augment(x, y, aug, rng)
            xs.append(x / 255.0)
            ys.append(y)
        out.append((np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32)))
    return out


# ---- loss and optimizer ----

def multiscale_loss(y, pyr, params, gamma: float):
    """sum_l alpha_l * mean_b sum_xy |flow_l - gt_l|_2, gt_l the bilinear
    (legacy) resize of y in level pixels, plus gamma * sum(p^2) / 2."""
    total = 0.0
    for alpha, flow in zip(ALPHAS, pyr):
        hw = flow.shape[1:3]
        gt = resize_bilinear(y, hw) * (float(hw[0]) / float(y.shape[1]))
        norm = torch.sqrt(torch.sum(torch.square(flow - gt), dim=-1) + 1e-16)
        total = total + alpha * torch.mean(torch.sum(norm, dim=(1, 2)))
    return total + gamma * 0.5 * sum(torch.sum(torch.square(p)) for p in params)


class Adam:
    """tf.train.AdamOptimizer: p -= lr * sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps),
    the correction in float32, eps on the uncorrected sqrt(v)."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        self.t += 1
        t = np.float32(self.t)
        corr = float(np.sqrt(np.float32(1.0) - np.float32(self.b2) ** t)
                     / (np.float32(1.0) - np.float32(self.b1) ** t))
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.add_(self.m[k] * corr / (self.v[k].sqrt() + self.eps), alpha=-self.lr)


def train_steps(params: dict, cfg: dict, batches, lr: float, gamma: float, numerics=None):
    """Run len(batches) reference steps from `params` (updated in place).
    Returns (losses, the first step's gradients {name: tensor})."""
    for p in params.values():
        p.requires_grad_(True)
    net = PWCNetRef(params, numerics=numerics, **cfg)
    opt = Adam(params, lr)
    names = list(params)
    losses, first = [], None
    for x, y in batches:
        x, y = x.to(next(iter(params.values())).device), y.to(next(iter(params.values())).device)
        _, pyr = net(x[:, 0], x[:, 1])
        loss = multiscale_loss(y, pyr, params.values(), gamma)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        grads = dict(zip(names, grads))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        opt.step(params, grads)
    for p in params.values():
        p.requires_grad_(False)
    return losses, first
