"""Optical-flow training dataset (image pairs + GT flow; copy of
fisr_tpu/data/flow_dataset.py, numpy only; batch assembly and augmentation
are timed in the stage spans of utils/profiling).

Rebuild of the tfoptflow dataset layer used to train PWC-Net itself
(dataset_base.py:103-1104): mode-dependent train/val/test splits with
persisted ID files, random-crop sampling to the training size, augmentation,
and a batch iterator. The reference fed tf.data through tf.py_func threads;
here batches are assembled with numpy, optionally on a thread pool, and
handed to the train step: the equivalent of its `map_and_batch` pipeline.

On-disk contract: a folder of samples, each `<id>_img1.png`, `<id>_img2.png`
(RGB) and `<id>_flow.flo` (Middlebury). `FlowDataset.synthetic()` builds an
in-memory corpus for tests.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Iterator, Optional

import numpy as np

from fisr_tpu_torch.data import flo as flo_io
from fisr_tpu_torch.data.augment import AugmentOptions, augment_pair
from fisr_tpu_torch.native import decode_png
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
    def _sample(self, idx: int, train: bool):
        x = self.pairs[idx].astype(np.float32)
        y = self.flows[idx]
        if self.crop_hw is not None:
            ch, cw = self.crop_hw
            h, w = y.shape[:2]
            y0 = self._rng.integers(0, h - ch + 1) if train else (h - ch) // 2
            x0 = self._rng.integers(0, w - cw + 1) if train else (w - cw) // 2
            x = x[:, y0 : y0 + ch, x0 : x0 + cw]
            y = y[y0 : y0 + ch, x0 : x0 + cw]
        if train and self.aug is not None:
            with profiling.span("data.augment"):
                x, y = augment_pair(x, y, self.aug, self._rng)
        return x / 255.0, y

    def batches(self, batch_size: int, train: bool = True,
                epoch_seed: int = 0, num_workers: int = 0) -> Iterator[dict]:
        """Batch iterator; num_workers > 0 assembles upcoming batches on a
        thread pool with a small lookahead — the analog of the reference's
        threaded tf.data feeder (dataset_base.py:1032-1083, tf.py_func
        under map_and_batch). Augmentation RNG draws happen on the
        submitting thread order, so worker count does not change the
        sample stream.
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

        def assemble(batch_idxs, samples=None):
            xs, ys = zip(*(samples or (self._sample(j, train) for j in batch_idxs)))
            return {"x": np.stack(xs).astype(np.float32),
                    "y": np.stack(ys).astype(np.float32)}

        # the `data.batch` span: drawing a batch's samples, and stacking them
        # where that runs on this thread; `data.batches` counts those yielded
        if num_workers <= 0:
            for chunk in chunks:
                with profiling.span("data.batch"):
                    b = assemble(chunk)
                profiling.count("data.batches")
                yield b
            return

        # _sample mutates self._rng: draw samples serially on submit order,
        # stack on the pool (the expensive part for big batches), keep a
        # bounded lookahead so memory stays ~2 batches
        from concurrent.futures import ThreadPoolExecutor
        from collections import deque

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            pending = deque()
            for chunk in chunks:
                with profiling.span("data.batch"):
                    samples = [self._sample(j, train) for j in chunk]
                pending.append(pool.submit(assemble, None, samples))
                if len(pending) > num_workers + 1:
                    profiling.count("data.batches")
                    yield pending.popleft().result()
            while pending:
                profiling.count("data.batches")
                yield pending.popleft().result()

    @property
    def train_size(self) -> int:
        return len(self._train_idx)

    @property
    def val_size(self) -> int:
        return len(self._val_idx)
