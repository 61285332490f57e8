"""4K benchmark evaluation, the reference's `test` phase (FISRnet.py:746-935;
port of fisr_tpu/infer/evaluate.py).

Per scene (5 input LR YUV PNGs, 7 GT HR PNGs) 3 windows of 3 frames slide
over the input; each window's 29-channel input is the images, its slice of
the flow normalised by /96/2 and its slice of the warps (FISRnet.py:834-843).
The windows run through patch-tiled inference, are trimmed and stitched, and
every frame is scored with PSNR and SSIM in YUV.

Accounting (FISRnet.py:913-920): fr1 of every window and fr3 of the last are
VFI-SR frames; fr2 is the SR frame. Predictions are saved as RGB PNGs through
the MATLAB YUV->RGB with uint8 truncation (FISRnet.py:901-910), with the JAX
package's native constants (native.yuv2rgb_matlab_u8), so the saved frames
are its bits. PNGs are read and written by the host runtime (native).

All three windows of a scene ride the batch axis of one tiled call.
`evaluate_test_set` reads the .flo and .mat files and hands their arrays to
`evaluate_scenes`, which does the rest and needs no HDF5 reader.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from fisr_tpu_torch.data import flo as flo_io
from fisr_tpu_torch.data import matio
from fisr_tpu_torch.data.png_io import list_pngs
from fisr_tpu_torch.native import decode_png, encode_png, yuv2rgb_matlab_u8
from fisr_tpu_torch.ops import metrics as M

N_IN_SEQ = 3
N_TEST_IN_SEQ = 5
N_GT_SEQ = 3  # frames predicted per window

__all__ = ["EvalResult", "evaluate_test_set", "evaluate_scenes"]


@dataclasses.dataclass
class EvalResult:
    psnr_vfi_sr: float
    psnr_sr: float
    ssim_vfi_sr: float
    ssim_sr: float
    sec_per_frame: float
    n_frames: int
    compile_sec: float = 0.0  # the one warm-up call, not in sec_per_frame


def evaluate_test_set(runner, test_data_dir: str, test_label_dir: str, flow_path: str,
                      warp_path: str, out_dir: Optional[str] = None,
                      input_size: Sequence[int] = (1080, 1920),
                      flow_norm: float = 96.0 * 2.0, verbose: bool = True,
                      ssim_impl: str = "gaussian") -> EvalResult:
    """The `test` phase from its files: `flow_path` is the 5-dim .flo
    ([scenes, 8, H, W, 2]) and `warp_path` the warp .mat ([scenes, 8, H, W,
    3], read into [0, 1]). `runner` is a TiledRunner or a
    FastTiledRunner."""
    flow = flo_io.read_flo_5dim(flow_path)
    warp = matio.read_warp_mat(warp_path)
    return evaluate_scenes(runner, test_data_dir, test_label_dir, flow, warp, out_dir,
                           input_size, flow_norm, verbose, ssim_impl)


def evaluate_scenes(runner, test_data_dir: str, test_label_dir: str, flow: np.ndarray,
                    warp: np.ndarray, out_dir: Optional[str] = None,
                    input_size: Sequence[int] = (1080, 1920),
                    flow_norm: float = 96.0 * 2.0, verbose: bool = True,
                    ssim_impl: str = "gaussian") -> EvalResult:
    """The `test` phase on arrays: flow [scenes, 8, H, W, 2] in pixels, warp
    [scenes, 8, H, W, 3] in [0, 1]. The Gaussian SSIM runs on the runner's
    device."""
    data_paths = list_pngs(test_data_dir)
    label_paths = list_pngs(test_label_dir)
    n_scenes = len(data_paths) // N_TEST_IN_SEQ
    n_label_seq = 2 * N_TEST_IN_SEQ - 3  # 7

    flow = np.transpose(flow, (0, 2, 3, 1, 4)).reshape(flow.shape[0], *flow.shape[2:4], -1)
    warp = np.transpose(warp, (0, 2, 3, 1, 4)).reshape(warp.shape[0], *warp.shape[2:4], -1)

    gh, gw = runner.grid
    h0, w0 = input_size
    h = h0 - h0 % (32 * gh)
    w = w0 - w0 % (32 * gw)
    sf = runner.sf

    psnr_fisr, psnr_sr, ssim_fisr, ssim_sr = [], [], [], []
    inf_time = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    n_windows = N_TEST_IN_SEQ - N_IN_SEQ + 1

    # One call on the window-batch shape before the timed region: a first
    # call pays the conv library's set-up, which would otherwise land in
    # scene 0's sec_per_frame. The reference's per-frame number also left
    # its graph build out (FISRnet.py:870-873).
    compile_sec = 0.0
    if n_scenes:
        t0 = time.time()
        runner(np.zeros((n_windows, h, w, 29), np.float32))
        compile_sec = time.time() - t0
        if verbose:
            print(f" <Test> warm-up: {compile_sec:.1f}s (excluded from sec_per_frame)",
                  flush=True)

    def ssim_u8(p, g):
        pu, gu = ((x * 255).astype(np.uint8).astype(np.float32) for x in (p, g))
        dev = runner.device
        return float(M.ssim(torch.from_numpy(pu).to(dev), torch.from_numpy(gu).to(dev),
                            max_val=255.0))

    for scene_i in range(n_scenes):
        scene_frames = [decode_png(data_paths[scene_i * N_TEST_IN_SEQ + s])[:h, :w]
                        for s in range(N_TEST_IN_SEQ)]
        windows = []
        for sample_i in range(n_windows):
            img = np.concatenate(scene_frames[sample_i:sample_i + N_IN_SEQ], 2)
            img = np.clip(img.astype(np.float64) / 255.0, 0, 1)
            fl = flow[scene_i, :h, :w, 4 * sample_i:4 * sample_i + 8] / flow_norm
            fl = np.clip(fl, -1, 1)
            wp = np.clip(warp[scene_i, :h, :w, 6 * sample_i:6 * sample_i + 12], 0, 1)
            windows.append(np.concatenate([img, fl, wp], axis=2))
        inp = np.stack(windows).astype(np.float32)

        t0 = time.time()
        preds = np.clip(runner(inp), 0, 1)
        inf_time.append((time.time() - t0) / n_windows)

        for sample_i in range(n_windows):
            pred = preds[sample_i]
            first = scene_i * n_label_seq + sample_i * 2
            label = np.concatenate([decode_png(label_paths[first + s]) for s in range(N_GT_SEQ)],
                                   axis=2)[:h * sf, :w * sf]
            label = np.clip(label.astype(np.float64) / 255.0, 0, 1)

            frame_psnr, frame_ssim = [], []
            for s in range(N_GT_SEQ):
                p = pred[:, :, 3 * s:3 * (s + 1)]
                g = label[:, :, 3 * s:3 * (s + 1)]
                frame_psnr.append(M.psnr_np(g, p.astype(np.float64), 1.0))
                # 'pil' is the reference's scorer (SSIM_PIL on uint8)
                frame_ssim.append(M.ssim_pil_like(p, g) if ssim_impl == "pil" else ssim_u8(p, g))

            psnr_fisr.append(frame_psnr[0])
            ssim_fisr.append(frame_ssim[0])
            psnr_sr.append(frame_psnr[1])
            ssim_sr.append(frame_ssim[1])
            if sample_i == n_windows - 1:
                psnr_fisr.append(frame_psnr[2])
                ssim_fisr.append(frame_ssim[2])

            if out_dir:
                pred_u8 = np.uint8(pred * 255)
                for s in range(N_GT_SEQ):
                    name = os.path.basename(label_paths[first + s])[3:]
                    encode_png(yuv2rgb_matlab_u8(pred_u8[:, :, 3 * s:3 * (s + 1)]),
                               os.path.join(out_dir, f"pred_{name}"))

            if verbose:
                print(f" <Test> scene {scene_i}-{sample_i}: PSNR fr1 (VFI-SR) "
                      f"{frame_psnr[0]:.4f} dB, fr2 (SR) {frame_psnr[1]:.4f} dB, "
                      f"fr3 (VFI-SR) {frame_psnr[2]:.4f} dB", flush=True)

    result = EvalResult(
        psnr_vfi_sr=float(np.mean(psnr_fisr)),
        psnr_sr=float(np.mean(psnr_sr)),
        ssim_vfi_sr=float(np.mean(ssim_fisr)),
        ssim_sr=float(np.mean(ssim_sr)),
        sec_per_frame=float(np.mean(inf_time)),
        n_frames=len(psnr_fisr) + len(psnr_sr),
        compile_sec=compile_sec,
    )
    if verbose:
        print(f"######### Test (average) PSNR: VFI-SR {result.psnr_vfi_sr:.4f} dB, "
              f"SR {result.psnr_sr:.4f} dB; SSIM: VFI-SR {result.ssim_vfi_sr:.4f}, "
              f"SR {result.ssim_sr:.4f}; {result.sec_per_frame:.3f}s/frame #########")
    return result
