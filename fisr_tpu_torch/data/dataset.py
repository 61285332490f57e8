"""In-memory training store + batch iterator (copy of fisr_tpu/data/dataset.py;
numpy arrays, with the batch gather's span and counter of utils/profiling).

Mirrors the reference's host-RAM data strategy (FISRnet.py:175-229): all six
training arrays are loaded up front, flows are normalized by /H/2 (H = patch
height, FISRnet.py:197,202), sequence dims are merged to channels, and the
last `val_size` samples form the validation split. Per-epoch shuffling uses
a seeded numpy permutation (FISRnet.py:628).

Under multi-host data parallelism each host takes its own shard-slice of the
store (shard_index/shard_count). Batch rows are gathered on threads by the
host runtime (native.gather_rows), as the JAX package gathers them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from fisr_tpu_torch.data import flo as flo_io
from fisr_tpu_torch.data import matio
from fisr_tpu_torch.native import gather_rows
from fisr_tpu_torch.utils import profiling

Batch = Dict[str, np.ndarray]

__all__ = ["TrainStore"]


def _merge(x: np.ndarray) -> np.ndarray:
    """[N, S, H, W, C] -> C-contiguous [N, H, W, S*C]. The train readers
    return axis-swapped views whose merge reshapes without a copy; the
    batch gather (native.gather_rows) would then copy the whole split on
    every batch, so the copy is made here, once."""
    n, s, h, w, c = x.shape
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1, 4))).reshape(n, h, w, s * c)


@dataclasses.dataclass
class TrainStore:
    data: np.ndarray       # [N, H, W, 15]  LR 5-frame stacks, [0,1]
    label: np.ndarray      # [N, 2H, 2W, 21] HR 7-frame stacks, [0,1]
    flow: np.ndarray       # [N, H, W, 16]  stride-1 flows, normalized
    flow_ss2: np.ndarray   # [N, H, W, 8]   stride-2 flows, normalized
    warp: np.ndarray       # [N, H, W, 24]  stride-1 warped frames, [0,1]
    warp_ss2: np.ndarray   # [N, H, W, 12]  stride-2 warped frames, [0,1]
    val_size: int = 320

    @classmethod
    def from_files(cls, data_path, label_path, flow_path, flow_ss2_path,
                   warp_path, warp_ss2_path, val_size: int = 320) -> "TrainStore":
        data = matio.read_train_mat(data_path, "LR_data")
        label = matio.read_train_mat(label_path, "HR_data")
        h = data.shape[2]
        flow = flo_io.read_flo_5dim(flow_path) / h / 2.0
        flow_ss2 = flo_io.read_flo_5dim(flow_ss2_path) / h / 2.0
        warp = matio.read_warp_mat(warp_path)
        warp_ss2 = matio.read_warp_mat(warp_ss2_path)
        return cls(
            data=_merge(data), label=_merge(label), flow=_merge(flow),
            flow_ss2=_merge(flow_ss2), warp=_merge(warp),
            warp_ss2=_merge(warp_ss2), val_size=val_size,
        )

    # -- splits ---------------------------------------------------------
    def _split(self, arr: np.ndarray, val: bool) -> np.ndarray:
        return arr[-self.val_size:] if val else arr[: -self.val_size]

    @property
    def train_size(self) -> int:
        return self.data.shape[0] - self.val_size

    def num_batches(self, batch_size: int) -> int:
        return self.train_size // batch_size

    def batches(self, batch_size: int, epoch_seed: int,
                shard_index: int = 0, shard_count: int = 1) -> Iterator[Batch]:
        """Shuffled epoch of train batches (per-epoch permutation like
        FISRnet.py:628); optional contiguous sharding for multi-host DP.
        Each batch's gather is the span `data.store_batch`, and each batch
        yielded counts one `data.store_batches` (utils/profiling)."""
        rng = np.random.default_rng(epoch_seed)
        perm = rng.permutation(self.train_size)
        n = self.num_batches(batch_size)
        lo = (n // shard_count) * shard_index
        hi = (n // shard_count) * (shard_index + 1) if shard_index < shard_count - 1 else n
        for i in range(lo, hi):
            idx = perm[batch_size * i : batch_size * (i + 1)].astype(np.int64)
            with profiling.span("data.store_batch"):
                batch = {
                    "data": gather_rows(self._split(self.data, False), idx),
                    "label": gather_rows(self._split(self.label, False), idx),
                    "flow": gather_rows(self._split(self.flow, False), idx),
                    "flow_ss2": gather_rows(self._split(self.flow_ss2, False), idx),
                    "warp": gather_rows(self._split(self.warp, False), idx),
                    "warp_ss2": gather_rows(self._split(self.warp_ss2, False), idx),
                }
            profiling.count("data.store_batches")
            yield batch

    def val_batches(self, batch_size: int) -> Iterator[Batch]:
        n = self.val_size // batch_size
        for i in range(n):
            sl = slice(batch_size * i, batch_size * (i + 1))
            yield {
                "data": self._split(self.data, True)[sl],
                "label": self._split(self.label, True)[sl],
                "flow": self._split(self.flow, True)[sl],
                "warp": self._split(self.warp, True)[sl],
            }
