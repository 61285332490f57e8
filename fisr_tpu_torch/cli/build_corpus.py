"""Training-corpus builder: raw frame folder -> full FISR training dataset
(port of fisr_tpu/cli/build_corpus.py).

The reference ships no data-construction code for its 10,086-sample corpus
("pre-made to avoid heavy training time", main.py:33-37; the extraction
scripts were MATLAB-side and unreleased). From any folder of consecutive
frames (e.g. extracted from 4K/60fps video) this builds every training
artifact in the reference's on-disk formats:

  1. temporal/spatial decimation: a 9-frame window yields the 7-frame HR/HFR
     ground truth (frames 1..7) and the 5-frame LR/LFR input (frames
     0,2,4,6,8 downscaled 2x with the TF1-legacy bicubic == subsampling);
  2. random co-located patch crops (HR 2p x 2p, LR p x p; default p=96);
  3. bidirectional PWC-Net flows at temporal strides 1 and 2 (custom 5-dim
     .flo, with the x2-upscale inference trick), on `device`;
  4. +0.5-flow warped middle frames (MATLAB-compatible _warp.mat).

Frames may be RGB (converted to YUV with the MATLAB constants, like the
reference datasets, in double as the JAX package's native runtime converts
them: native.rgb2yuv_matlab_u8) or already YUV (--yuv). The .mat files go
through data/matio (the port's own HDF5 writer). `main` runs without TF32
and with cuDNN's deterministic algorithms (device.exact_f32,
device.cudnn_deterministic), so a corpus built twice from the same frames
and seed is the same bits.

Usage:
  python -m fisr_tpu_torch.cli.build_corpus --frames ./frames_4k --out ./data/train \\
      --samples 1000 --patch 96 --pwc_ckpt DIR [--yuv]

--pwc_ckpt is required: the JAX CLI falls back to randomly initialized
PWC-Net weights, and the port stops instead, as its other entry points do.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["build_corpus", "main"]

WINDOW = 9  # raw frames per sample window
N_LR, N_HR = 5, 7


def build_corpus(frame_paths, out_dir: str, n_samples: int, patch: int = 96, *, pwc,
                 is_yuv: bool = False, seed: int = 0, stride: int = 4, verbose: bool = True,
                 device="cuda") -> dict:
    """Writes the corpus with the PWC-Net module `pwc`; returns the
    TrainStore.from_files path dict."""
    from fisr_tpu_torch.cli.prepare import flows_for_sequences, warps_for_sequences
    from fisr_tpu_torch.data import flo as flo_io
    from fisr_tpu_torch.data import matio
    from fisr_tpu_torch.native import decode_png_batch, rgb2yuv_matlab_u8

    if len(frame_paths) < WINDOW:
        raise ValueError(f"need >= {WINDOW} frames, got {len(frame_paths)}")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    n_windows = (len(frame_paths) - WINDOW) // stride + 1
    lr = np.zeros((n_samples, N_LR, patch, patch, 3), np.float32)
    hr = np.zeros((n_samples, N_HR, 2 * patch, 2 * patch, 3), np.float32)

    cache_start, cache = None, None
    for i in range(n_samples):
        w_i = int(rng.integers(0, n_windows)) * stride
        if w_i != cache_start:
            frames = decode_png_batch(frame_paths[w_i:w_i + WINDOW])
            if not is_yuv:
                frames = rgb2yuv_matlab_u8(frames)
            cache = frames.astype(np.float32)  # [9, H, W, 3] YUV
            cache_start = w_i
        fh, fw = cache.shape[1], cache.shape[2]
        y0 = int(rng.integers(0, fh - 2 * patch + 1)) & ~1  # even for a clean /2
        x0 = int(rng.integers(0, fw - 2 * patch + 1)) & ~1
        hr_win = cache[:, y0:y0 + 2 * patch, x0:x0 + 2 * patch]
        hr[i] = hr_win[1:8]
        lr[i] = hr_win[::2][:, ::2, ::2]  # TF1-legacy bicubic /2 == subsample
        if verbose and (i + 1) % 50 == 0:
            print(f"patches [{i + 1}/{n_samples}]", flush=True)

    if verbose:
        print("computing flows (ss1, ss2)...", flush=True)
    flow_ss1 = flows_for_sequences(pwc, lr, ss=1, device=device)
    flow_ss2 = flows_for_sequences(pwc, lr, ss=2, device=device)
    if verbose:
        print("warping middle frames...", flush=True)
    warp_ss1 = warps_for_sequences(lr, flow_ss1, ss=1, device=device)
    warp_ss2 = warps_for_sequences(lr, flow_ss2, ss=2, device=device)

    paths = {
        "data_path": os.path.join(out_dir, "LR_corpus_5seq.mat"),
        "label_path": os.path.join(out_dir, "HR_corpus_5seq.mat"),
        "flow_path": os.path.join(out_dir, "LR_corpus_5seq_ss1.flo"),
        "flow_ss2_path": os.path.join(out_dir, "LR_corpus_5seq_ss2.flo"),
        "warp_path": os.path.join(out_dir, "LR_corpus_5seq_ss1_warp.mat"),
        "warp_ss2_path": os.path.join(out_dir, "LR_corpus_5seq_ss2_warp.mat"),
    }
    matio.write_train_mat(paths["data_path"], "LR_data", lr)
    matio.write_train_mat(paths["label_path"], "HR_data", hr)
    flo_io.write_flo_5dim(flow_ss1, paths["flow_path"])
    flo_io.write_flo_5dim(flow_ss2, paths["flow_ss2_path"])
    matio.write_warp_mat(warp_ss1, paths["warp_path"])
    matio.write_warp_mat(warp_ss2, paths["warp_ss2_path"])
    if verbose:
        print(f"[*] corpus of {n_samples} samples written to {out_dir}")
    return paths


def main(argv=None):
    from fisr_tpu_torch.cli.prepare import load_pwc
    from fisr_tpu_torch.data.png_io import list_pngs
    from fisr_tpu_torch.device import cudnn_deterministic, exact_f32, resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", required=True, help="folder of consecutive PNGs")
    p.add_argument("--out", required=True)
    p.add_argument("--samples", type=int, default=1000)
    p.add_argument("--patch", type=int, default=96)
    p.add_argument("--stride", type=int, default=4,
                   help="frame stride between candidate windows")
    p.add_argument("--yuv", action="store_true",
                   help="frames are already YUV-in-PNG (default: RGB)")
    p.add_argument("--pwc_ckpt", type=str, default=None,
                   help="PWC-Net checkpoint directory (the port's or the JAX package's)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions on the CPU")
    args = p.parse_args(argv)

    if not args.pwc_ckpt:
        raise SystemExit("no pwc weights: pass --pwc_ckpt (a checkpoint directory; "
                         "python -m fisr_tpu_torch.convert.cli converts TF1 and orbax ones)")
    device = resolve_device(args.device)
    # a corpus is f32 without TF32, and the same bits every time it is built
    with exact_f32(), cudnn_deterministic():
        return build_corpus(list_pngs(args.frames), args.out, args.samples, args.patch,
                            pwc=load_pwc(args.pwc_ckpt, device), is_yuv=args.yuv,
                            seed=args.seed, stride=args.stride, device=device)


if __name__ == "__main__":
    main()
