"""Optical-flow training dataset (image pairs + GT flow; port of
fisr_tpu/data/flow_dataset.py; batch assembly and augmentation are timed in
the stage spans of utils/profiling).

Rebuild of the tfoptflow dataset layer used to train PWC-Net itself
(dataset_base.py:103-1104): mode-dependent train/val/test splits with
persisted ID files, random-crop sampling to the training size, augmentation,
and a batch iterator. The reference fed tf.data through tf.py_func threads;
here each sample's crop corner and augmentation plan are drawn in Python,
and the host runtime's fused pass (native.flow_sample, threaded C++) crops,
augments and scales the sample into its slot of the batch's float32 arrays:
the equivalent of its `map_and_batch` pipeline, with numpy's bits.

On-disk contract: a folder of samples, each `<id>_img1.png`, `<id>_img2.png`
(RGB) and `<id>_flow.flo` (Middlebury). `FlowDataset.synthetic()` builds an
in-memory corpus for tests.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import os
from typing import Iterator, Optional

import numpy as np

from fisr_tpu_torch.data import flo as flo_io
from fisr_tpu_torch.data.augment import AugmentOptions, plan_augment
from fisr_tpu_torch.native import decode_png, flow_sample
from fisr_tpu_torch.utils import profiling

__all__ = ["FlowDataset"]


def _id_line(i: str) -> str:
    # dataset_base.py:253-254 writes "img1###img2###flow" tuples per line
    return f"{i}_img1.png###{i}_img2.png###{i}_flow.flo"


def _write_id_file(path: str, ids) -> None:
    with open(path, "w") as f:
        f.writelines(_id_line(i) + "\n" for i in ids)


def _read_id_file(path: str):
    with open(path) as f:
        return [line.rstrip().split("###")[0][: -len("_img1.png")]
                for line in f if line.strip()]


@dataclasses.dataclass
class FlowDataset:
    pairs: np.ndarray  # [N, 2, H, W, 3] uint8
    flows: np.ndarray  # [N, H, W, 2] float32
    val_split: float = 0.1
    crop_hw: Optional[tuple] = None
    aug: Optional[AugmentOptions] = None
    seed: int = 1969  # reference augmenter seed (augment.py:35)
    split_sizes: Optional[tuple] = None  # (n_train, n_val) from ID files
    ids: Optional[list] = None  # sample IDs, train split then val split

    def __post_init__(self):
        n = len(self.pairs)
        if self.split_sizes is not None:
            n_train, n_val = self.split_sizes
            if n_train + n_val != n:
                raise ValueError(f"split_sizes {self.split_sizes} do not sum to {n} samples")
        else:
            n_val = max(1, int(n * self.val_split)) if n > 1 else 0
            n_train = n - n_val
        self._train_idx = np.arange(0, n_train)
        self._val_idx = np.arange(n_train, n)
        self._rng = np.random.default_rng(self.seed)

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_folder(cls, folder: str, persist_split: bool = True,
                    **kw) -> "FlowDataset":
        """Load a corpus folder; train/val split is PERSISTED in ID files.

        Mirrors dataset_base.py:197-265: the split lives in
        `train_{val_split}split.txt` / `val_{val_split}split.txt` next to
        the samples (lines of `img1###img2###flow` basenames). First load
        creates them; later loads — including after the corpus is
        regenerated or extended — reuse them byte-identically, so training
        runs stay comparable. persist_split=False keeps the old in-memory
        fractional split.
        """
        val_split = kw.get("val_split", cls.val_split)
        ids = sorted(
            os.path.basename(p)[: -len("_img1.png")]
            for p in glob.glob(os.path.join(folder, "*_img1.png"))
        )
        if persist_split:
            trn_file = os.path.join(folder, f"train_{val_split}split.txt")
            val_file = os.path.join(folder, f"val_{val_split}split.txt")
            if os.path.exists(trn_file) and os.path.exists(val_file):
                trn_ids = _read_id_file(trn_file)
                val_ids = _read_id_file(val_file)
                missing = [i for i in trn_ids + val_ids if i not in set(ids)]
                if missing:
                    raise FileNotFoundError(
                        f"split manifests reference missing samples {missing[:5]}"
                        f" — regenerate the corpus or delete {trn_file}")
            else:
                n = len(ids)
                n_val = max(1, int(n * val_split)) if n > 1 else 0
                trn_ids, val_ids = ids[: n - n_val], ids[n - n_val:]
                _write_id_file(trn_file, trn_ids)
                _write_id_file(val_file, val_ids)
            ids = trn_ids + val_ids
            kw["split_sizes"] = (len(trn_ids), len(val_ids))
        pairs, flows = [], []
        for i in ids:
            img1 = decode_png(os.path.join(folder, f"{i}_img1.png"))
            img2 = decode_png(os.path.join(folder, f"{i}_img2.png"))
            pairs.append(np.stack([img1, img2]))
            flows.append(flo_io.read_flo(os.path.join(folder, f"{i}_flow.flo")))
        return cls(np.stack(pairs), np.stack(flows).astype(np.float32),
                   ids=list(ids), **kw)

    @classmethod
    def synthetic(cls, n: int = 8, h: int = 64, w: int = 64, seed: int = 0,
                  **kw) -> "FlowDataset":
        """Shifted-pattern pairs whose GT flow is the (uniform) shift."""
        rng = np.random.default_rng(seed)
        pairs = np.zeros((n, 2, h, w, 3), np.uint8)
        flows = np.zeros((n, h, w, 2), np.float32)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for i in range(n):
            fx, fy = rng.uniform(0.05, 0.2, 2)
            ph = rng.uniform(0, 6.28, 3)
            u, v = rng.integers(-4, 5, 2)
            for t, (du, dv) in enumerate(((0, 0), (u, v))):
                img = np.stack(
                    [127.5 + 127.5 * np.sin(fx * (xx - du) + fy * (yy - dv) + ph[c])
                     for c in range(3)], -1)
                pairs[i, t] = img.astype(np.uint8)
            flows[i, :, :, 0] = u
            flows[i, :, :, 1] = v
        return cls(pairs, flows, **kw)

    @classmethod
    def synthetic_textured(cls, n: int = 512, h: int = 128, w: int = 128,
                           seed: int = 0, max_shift: float = 4.0,
                           subpixel: bool = True, **kw) -> "FlowDataset":
        """Multi-octave noise textures + uniform translations (GT = shift).

        The sinusoid corpus above is feature-poor (one frequency per
        channel), which is why from-scratch PWC training descends on the
        loss but never beats the zero-flow EPE baseline (PERF.md round-2
        caveat). This corpus has dense local structure at several scales —
        the minimum for COST-VOLUME MATCHING to be learnable: coarse
        octaves give the top pyramid levels unambiguous context, fine
        octaves give subpixel precision at the bottom.

        Pairs are two crops of one larger canvas offset by the flow, so
        shifted content is real (no wrap seams); subpixel=True draws
        continuous shifts realized by bilinear resampling (the GT flow
        stays exact).
        """
        rng = np.random.default_rng(seed)
        pad = int(np.ceil(max_shift)) + 1
        ch, cw = h + 2 * pad, w + 2 * pad

        def zoom(a, hh, ww):
            """Bilinear resize [gh, gw, 3] -> [hh, ww, 3] (numpy only)."""
            ys = np.linspace(0, a.shape[0] - 1, hh)
            xs = np.linspace(0, a.shape[1] - 1, ww)
            y0 = np.floor(ys).astype(int)
            x0 = np.floor(xs).astype(int)
            y1 = np.minimum(y0 + 1, a.shape[0] - 1)
            x1 = np.minimum(x0 + 1, a.shape[1] - 1)
            wy = (ys - y0)[:, None, None]
            wx = (xs - x0)[None, :, None]
            return (a[y0][:, x0] * (1 - wy) * (1 - wx)
                    + a[y0][:, x1] * (1 - wy) * wx
                    + a[y1][:, x0] * wy * (1 - wx)
                    + a[y1][:, x1] * wy * wx)

        pairs = np.zeros((n, 2, h, w, 3), np.uint8)
        flows = np.zeros((n, h, w, 2), np.float32)
        for i in range(n):
            canvas = np.zeros((ch, cw, 3))
            # octaves: coarse blobs -> fine grain, amplitudes decaying
            for cell, amp in ((16, 0.45), (8, 0.25), (4, 0.2), (2, 0.1)):
                g = rng.uniform(size=(ch // cell + 2, cw // cell + 2, 3))
                canvas += amp * zoom(g, ch, cw)
            canvas = (canvas - canvas.min()) / (np.ptp(canvas) + 1e-9)
            if subpixel:
                u, v = rng.uniform(-max_shift, max_shift, 2)
            else:
                u, v = rng.integers(-int(max_shift), int(max_shift) + 1, 2)
            # img1(q) == img2(q + f): img2 is the canvas window shifted by -f
            iu, iv = int(np.floor(u)), int(np.floor(v))
            fu, fv = u - iu, v - iv
            base = canvas[pad - iv - 1 : pad - iv + h + 1,
                          pad - iu - 1 : pad - iu + w + 1]
            img2 = (base[1:h + 1, 1:w + 1] * (1 - fv) * (1 - fu)
                    + base[1:h + 1, 0:w] * (1 - fv) * fu
                    + base[0:h, 1:w + 1] * fv * (1 - fu)
                    + base[0:h, 0:w] * fv * fu)
            pairs[i, 0] = (canvas[pad : pad + h, pad : pad + w] * 255).astype(np.uint8)
            pairs[i, 1] = np.clip(img2 * 255, 0, 255).astype(np.uint8)
            flows[i, :, :, 0] = u
            flows[i, :, :, 1] = v
        return cls(pairs, flows, **kw)

    # -- iteration ---------------------------------------------------------
    def _draw(self, train: bool):
        """One sample's crop corner and augmentation plan (None: none), drawn
        from the sample RNG in the reference's order: crop row, crop column,
        then the Augmenter's draws."""
        h, w = self.flows.shape[1:3]
        ch, cw = self.crop_hw or (h, w)
        if self.crop_hw is None:
            corner = (0, 0)
        elif train:
            y0 = self._rng.integers(0, h - ch + 1)
            corner = (y0, self._rng.integers(0, w - cw + 1))
        else:
            corner = ((h - ch) // 2, (w - cw) // 2)
        plan = plan_augment(self.aug, self._rng, ch, cw) if train and self.aug is not None \
            else None
        return corner, plan

    def _assemble(self, batch_idxs, train: bool) -> dict:
        """The batch of `batch_idxs`: each sample drawn in turn, then cropped,
        augmented and scaled by the fused pass straight into its slot."""
        h, w = self.flows.shape[1:3]
        ch, cw = self.crop_hw or (h, w)
        x = np.empty((len(batch_idxs), 2, ch, cw, 3), np.float32)
        y = np.empty((len(batch_idxs), ch, cw, 2), np.float32)
        for k, j in enumerate(batch_idxs):
            corner, plan = self._draw(train)
            args = (self.pairs[j], self.flows[j], corner, (ch, cw), plan, x[k], y[k])
            if plan is None:
                flow_sample(*args)
            else:
                with profiling.span("data.augment"):
                    flow_sample(*args)
            profiling.count("data.fused")
        return {"x": x, "y": y}

    def batches(self, batch_size: int, train: bool = True,
                epoch_seed: int = 0, num_workers: int = 0) -> Iterator[dict]:
        """Batch iterator; num_workers > 0 keeps num_workers + 1 assembled
        batches ahead of the one yielded — the analog of the reference's
        threaded tf.data feeder (dataset_base.py:1032-1083, tf.py_func
        under map_and_batch), whose per-sample work runs here on the host's
        cores inside each sample's fused pass. Draws and work run in
        submission order on this thread, so worker count does not change
        the sample stream.
        """
        idxs = self._train_idx if train else self._val_idx
        if train:
            idxs = np.random.default_rng(epoch_seed).permutation(idxs)
        starts = list(range(0, len(idxs) - batch_size + 1, batch_size))
        chunks = [idxs[i : i + batch_size] for i in starts]
        # eval must see EVERY sample: yield the final partial batch too
        # (training keeps fixed-size shuffled batches — the reference's
        # contract; its eval pads the last round, model_pwcnet.py:843-849).
        # Without this, val_size < batch_size yields NOTHING and best-ckpt
        # ranking would run on empty metrics.
        tail = len(starts) * batch_size
        if not train and tail < len(idxs):
            chunks.append(idxs[tail:])

        # the `data.batch` span: drawing and assembling a batch (main, in
        # `next(feed)`); `data.batches` counts those yielded
        ahead = collections.deque()
        keep = num_workers + 1 if num_workers > 0 else 0
        for chunk in chunks:
            with profiling.span("data.batch"):
                ahead.append(self._assemble(chunk, train))
            while len(ahead) > keep:
                profiling.count("data.batches")
                yield ahead.popleft()
        while ahead:
            profiling.count("data.batches")
            yield ahead.popleft()

    @property
    def train_size(self) -> int:
        return len(self._train_idx)

    @property
    def val_size(self) -> int:
        return len(self._val_idx)
