"""Optical-flow file I/O (copy of fisr_tpu/data/flo.py; numpy only).

Two formats, both binary little-endian with the Middlebury magic 202021.25:

* the FISR custom **5-dim .flo** (utils.py:57-74 reader; writer in
  FISR_tfoptflow/FISR_for_video_pwcnet_predict_from_img_test.py:57-81):
  float32 magic, int32 N, N_seq, h, w, then float32 payload of shape
  [N, N_seq, h, w, 2] — NOT standard Middlebury;

* standard **Middlebury 2-dim .flo** ([h, w, 2]; optflow.py:65-161 parity)
  plus its width-before-height int32 header.
"""

from __future__ import annotations

import os

import numpy as np

MAGIC = np.float32(202021.25)

__all__ = ["read_flo_5dim", "write_flo_5dim", "read_flo", "write_flo"]


def read_flo_5dim(path: str | os.PathLike) -> np.ndarray:
    """Read the FISR custom 5-dim .flo: returns float32 [N, N_seq, h, w, 2]."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != MAGIC:
            raise ValueError(f"bad magic in {path!r}: not a .flo file")
        n, n_seq, h, w = (int(np.fromfile(f, np.int32, count=1)[0]) for _ in range(4))
        data = np.fromfile(f, np.float32, count=n * n_seq * h * w * 2)
    if data.size != n * n_seq * h * w * 2:
        raise ValueError(f"truncated .flo payload in {path!r}")
    return data.reshape(n, n_seq, h, w, 2)


def write_flo_5dim(flow: np.ndarray, path: str | os.PathLike) -> None:
    """Write [N, N_seq, h, w, 2] float32 in the FISR custom 5-dim layout."""
    if flow.ndim != 5 or flow.shape[-1] != 2:
        raise ValueError(f"write_flo_5dim takes [N, N_seq, h, w, 2], got {flow.shape}")
    n, n_seq, h, w = flow.shape[:4]
    with open(path, "wb") as f:
        np.array([MAGIC], np.float32).tofile(f)
        for v in (n, n_seq, h, w):
            np.array([v], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_flo(path: str | os.PathLike) -> np.ndarray:
    """Standard Middlebury .flo: returns float32 [h, w, 2]."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != MAGIC:
            raise ValueError(f"bad magic in {path!r}: not a .flo file")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=h * w * 2)
    return data.reshape(h, w, 2)


def write_flo(flow: np.ndarray, path: str | os.PathLike) -> None:
    """Write [h, w, 2] float32 in standard Middlebury layout."""
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"write_flo takes [h, w, 2], got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([MAGIC], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)
