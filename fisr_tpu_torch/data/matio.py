"""MATLAB v7.3 (.mat / HDF5) readers and writer (copy of
fisr_tpu/data/matio.py).

Parity targets:
* `read_train_mat`  — utils.py:29-42 `read_mat_file`: keys 'LR_data' /
  'HR_data'; raw h5 layout [N, N_seq, C, W, H], swapaxes(2,4) ->
  [N, N_seq, H, W, C], /255 normalize to [0, 1].
* `read_warp_mat`   — utils.py:45-54 `read_mat_file_warp`: key 'pred';
  raw h5 layout reversed, transpose(4,3,2,1,0) -> [N, N_seq, H, W, C], /255.
* `write_warp_mat`  — hdf5storage matlab_compatible writer equivalent
  (FISR_for_video_warp_img_with_flo.py:131-137): stores the [N, N_seq, H,
  W, C] float32 array so that `read_warp_mat` round-trips, including the
  512-byte MATLAB userblock and MATLAB_class attribute so real MATLAB can
  open the file.

Note the two readers use *different* axis fixups (swapaxes vs full reverse)
because the upstream files were produced by different writers; we replicate
both exactly.

The files go through the port's own HDF5 codec (data/hdf5), so they are
read and written where h5py is not installed. The writer's files hold the
same datasets, attributes and userblock header as the JAX package's
h5py-written ones; their bytes may differ.
"""

from __future__ import annotations

import os

import numpy as np

from fisr_tpu_torch.data import hdf5

__all__ = ["read_train_mat", "read_warp_mat", "write_warp_mat", "write_train_mat"]


def read_train_mat(path: str | os.PathLike, key: str) -> np.ndarray:
    """Read 'LR_data'/'HR_data': [N, N_seq, H, W, C] float32 in [0, 1]."""
    with hdf5.File(path) as f:
        data = f[key].read()
    data = np.asarray(data, dtype=np.float32) / 255.0
    return np.swapaxes(data, 2, 4)


def read_warp_mat(path: str | os.PathLike, key: str = "pred") -> np.ndarray:
    """Read warped-frame mat: [N, N_seq, H, W, C] float32 in [0, 1]."""
    with hdf5.File(path) as f:
        data = f[key].read()
    data = np.asarray(data, dtype=np.float32) / 255.0
    return np.transpose(data, (4, 3, 2, 1, 0))


_MATLAB_HEADER = (
    b"MATLAB 7.3 MAT-file, Platform: GLNXA64, Created by: fisr_tpu_torch"
)


def _write_matlab_file(path, datasets: dict[str, np.ndarray]) -> None:
    """Write an HDF5 file MATLAB can open: userblock + MATLAB_class attrs.

    `datasets` values are stored verbatim (the row-major view); callers
    pre-arrange the axis layout each FISR reader expects to undo.
    """
    # the MAT-file header: text padded to 116 bytes, 8 bytes of subsystem
    # offset, version 0x0200 and the endian indicator
    header = _MATLAB_HEADER.ljust(116, b" ") + bytes(8) + b"\x00\x02IM"
    hdf5.write(path, datasets, attrs={"MATLAB_class": b"single"}, userblock=header)


def write_warp_mat(pred: np.ndarray, path: str | os.PathLike) -> None:
    """Write [N, N_seq, H, W, C] float32 YUV ([0,255] range) under key 'pred'.

    Round-trips through `read_warp_mat` (which divides by 255): the reader
    fully reverses the stored axes (hdf5storage column-major convention).
    """
    _write_matlab_file(path, {"pred": np.transpose(np.asarray(pred, np.float32))})


def write_train_mat(path: str | os.PathLike, key: str, data: np.ndarray) -> None:
    """Write a training-style mat ([N, N_seq, H, W, C], [0,255] uint8-range)
    so that `read_train_mat` round-trips (it swaps axes 2<->4 and /255)."""
    _write_matlab_file(path, {key: np.swapaxes(np.asarray(data, np.float32), 2, 4)})
