"""Offline data preparation: flows and warped frames for train/test corpora
(port of fisr_tpu/cli/prepare.py).

Rebuild of the three standalone tfoptflow prep scripts (SURVEY components
14-15):
  * FISR_pwcnet_predict_from_img_test.py - test-set flows from scene PNGs
    -> `<out>.flo` [n_scenes, 8, H, W, 2];
  * FISR_pwcnet_predict_from_mat.py      - training flows from the 5-frame
    LR .mat at temporal stride ss in {1, 2} -> [N, 8|4, h, w, 2];
  * FISR_warp_mat_with_flo.py            - flow-warped middle frames from
    .flo + source frames -> `_warp.mat` [N, 8|4, h, w, 3] (YUV, 0-255).

Flow layout parity: pair i contributes (forward, backward) at sequence
positions (2i, 2i+1), so sliding window w consumes flows [4w : 4w+8) merged
channels, what Tensor_slicer_recurrent_flow expects (ops.py:99-106). Flows
and warps run on `device` (infer/video.make_flow_fn under the F32 policy,
one cost-volume launch a pyramid level a pair, and make_warp_fn); the .mat
commands read and write through data/matio, which needs h5py.

Usage:
  python -m fisr_tpu_torch.cli.prepare flow-from-pngs --png_dir D --out f.flo --pwc_ckpt C
  python -m fisr_tpu_torch.cli.prepare flow-from-mat  --mat M --ss 1 --out f.flo --pwc_ckpt C
  python -m fisr_tpu_torch.cli.prepare warp-from-mat  --mat M --flo f.flo --ss 1 --out w.mat

The PWC-Net comes from --pwc_ckpt, a checkpoint directory of the port or of
the JAX package (its newest step). Without it the flow commands stop: the
JAX CLI warns and runs randomly initialized weights.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fisr_tpu_torch.device import resolve_device

__all__ = ["main", "flows_for_sequences", "warps_for_sequences", "load_pwc"]


def _pairs_for_stride(n_frames: int, ss: int):
    return [(i, i + ss) for i in range(0, n_frames - ss, ss)]


def flows_for_sequences(pwc, seqs_yuv255: np.ndarray, ss: int = 1, policy=None,
                        device="cuda") -> np.ndarray:
    """seqs: [N, n_frames, h, w, 3] YUV in [0,255] -> [N, 2*n_pairs, h, w, 2]
    bidirectional flows (pixel units) of the PWC-Net module `pwc` (policy:
    F32 by default)."""
    from fisr_tpu_torch.infer.video import make_flow_fn
    from fisr_tpu_torch.ops.conv import F32

    dev = resolve_device(device)
    flow_fn = make_flow_fn(pwc.cfg, policy or F32)
    n, n_frames = seqs_yuv255.shape[:2]
    pairs = _pairs_for_stride(n_frames, ss)
    out = np.zeros((n, 2 * len(pairs), *seqs_yuv255.shape[2:4], 2), np.float32)
    for i in range(n):
        seq = torch.from_numpy(np.asarray(seqs_yuv255[i], np.float32)).to(dev)
        flows = [flow_fn(pwc, seq[a:a + 1], seq[b:b + 1])[0] for a, b in pairs]
        out[i] = torch.cat(flows).float().cpu().numpy()
    return out


def warps_for_sequences(seqs_yuv255: np.ndarray, flows: np.ndarray, ss: int = 1,
                        device="cuda") -> np.ndarray:
    """Middle-frame warps: [N, 2*n_pairs, h, w, 3] YUV [0,255] (the
    reference's `pred` layout, FISR_warp_mat_with_flo.py:95-129)."""
    from fisr_tpu_torch.infer.video import make_warp_fn

    dev = resolve_device(device)
    warp_fn = make_warp_fn()
    n, n_frames = seqs_yuv255.shape[:2]
    pairs = _pairs_for_stride(n_frames, ss)
    out = np.zeros((n, 2 * len(pairs), *seqs_yuv255.shape[2:4], 3), np.float32)
    for i in range(n):
        seq = torch.from_numpy(np.asarray(seqs_yuv255[i], np.float32)).to(dev)
        fl = torch.from_numpy(np.asarray(flows[i], np.float32)).to(dev)
        warps = [warp_fn(seq[a:a + 1], seq[b:b + 1], fl[None, 2 * k:2 * k + 2])[0]
                 for k, (a, b) in enumerate(pairs)]
        out[i] = torch.cat(warps).float().cpu().numpy()
    return out


def load_pwc(ckpt_dir: str, device="cuda"):
    """The PWC-Net module of a checkpoint directory's newest step (the port's
    or the JAX package's), its params unwrapped from the saved tree."""
    from fisr_tpu_torch.convert.params import pwcnet_from_jax
    from fisr_tpu_torch.train.checkpoint import CheckpointManager

    tree = CheckpointManager(ckpt_dir).restore()
    return pwcnet_from_jax(tree["params"] if "params" in tree else tree, device=device)


def main(argv=None):
    from fisr_tpu_torch.data import flo as flo_io
    from fisr_tpu_torch.data import matio
    from fisr_tpu_torch.data.png_io import list_pngs, read_png

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cmd", choices=["flow-from-pngs", "flow-from-mat", "warp-from-mat"])
    p.add_argument("--png_dir", type=str, help="scene PNG folder (YUV)")
    p.add_argument("--frames_per_scene", type=int, default=5)
    p.add_argument("--mat", type=str, help="5-frame LR .mat (key LR_data)")
    p.add_argument("--flo", type=str, help="input .flo (for warp)")
    p.add_argument("--ss", type=int, default=1, choices=[1, 2])
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--pwc_ckpt", type=str, default=None,
                   help="PWC-Net checkpoint directory (the port's or the JAX package's); "
                        "the flow commands need it")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions on the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    def pwc():
        if not args.pwc_ckpt:
            raise SystemExit("no pwc weights: pass --pwc_ckpt (a checkpoint directory; "
                             "python -m fisr_tpu_torch.convert.cli converts TF1 and orbax ones)")
        return load_pwc(args.pwc_ckpt, device)

    if args.cmd == "flow-from-pngs":
        paths = list_pngs(args.png_dir)
        k = args.frames_per_scene
        seqs = np.stack([
            np.stack([read_png(p) for p in paths[i:i + k]])
            for i in range(0, len(paths) - k + 1, k)
        ]).astype(np.float32)
        flo_io.write_flo_5dim(flows_for_sequences(pwc(), seqs, args.ss, device=device), args.out)
    elif args.cmd == "flow-from-mat":
        seqs = matio.read_train_mat(args.mat, "LR_data") * 255.0
        flo_io.write_flo_5dim(flows_for_sequences(pwc(), seqs, args.ss, device=device), args.out)
    else:  # warp-from-mat
        seqs = matio.read_train_mat(args.mat, "LR_data") * 255.0
        flows = flo_io.read_flo_5dim(args.flo)
        matio.write_warp_mat(warps_for_sequences(seqs, flows, args.ss, device=device), args.out)
    print(f"[*] wrote {args.out}")


if __name__ == "__main__":
    main()
