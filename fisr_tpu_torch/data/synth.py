"""Synthetic FISR-format data generation (copy of fisr_tpu/data/synth.py;
numpy only).

The reference repo ships no training corpus or checkpoint (data/info.txt
placeholders only), so tests, benchmarks, and end-to-end CLI runs use a
synthetic corpus with the exact on-disk contract: 5-frame LR /96x96 + 7-frame
HR /192x192 .mat stacks, custom 5-dim .flo flows (stride 1: 8 bidirectional,
stride 2: 4), and warped-frame .mat stacks — moving-gradient scenes so flow
and interpolation are meaningful, not noise.
"""

from __future__ import annotations

import os

import numpy as np

from fisr_tpu_torch.data import flo as flo_io
from fisr_tpu_torch.data import matio
from fisr_tpu_torch.data.dataset import TrainStore, _merge

__all__ = ["synthetic_arrays", "synthetic_store", "synthetic_video_windows",
           "write_synthetic_corpus", "write_synthetic_test_set",
           "write_synthetic_video_folder", "write_synthetic_video_scene"]


def _scene(rng, n_frames: int, h: int, w: int, return_motion: bool = False):
    """Moving smooth pattern, [n_frames, h, w, 3] in [0, 255]."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy = rng.uniform(0.02, 0.08, 2)
    vx, vy = rng.uniform(-2.0, 2.0, 2)
    phase = rng.uniform(0, 6.28, 3)
    frames = []
    for t in range(n_frames):
        chans = [
            127.5 + 127.5 * np.sin(fx * (xx - vx * t) + fy * (yy - vy * t) + phase[c])
            for c in range(3)
        ]
        frames.append(np.stack(chans, -1))
    out = np.stack(frames).astype(np.float32)
    return (out, (vx, vy)) if return_motion else out


def synthetic_arrays(n_samples: int = 8, h: int = 96, w: int = 96, seed: int = 0):
    """Returns dict of 5-dim arrays in the reference's units:
    LR [N,5,h,w,3] & HR [N,7,2h,2w,3] in [0,255]; flows in pixels;
    warps in [0,255]."""
    rng = np.random.default_rng(seed)
    lr = np.zeros((n_samples, 5, h, w, 3), np.float32)
    hr = np.zeros((n_samples, 7, 2 * h, 2 * w, 3), np.float32)
    flow = np.zeros((n_samples, 8, h, w, 2), np.float32)
    flow_ss2 = np.zeros((n_samples, 4, h, w, 2), np.float32)
    warp = np.zeros((n_samples, 8, h, w, 3), np.float32)
    warp_ss2 = np.zeros((n_samples, 4, h, w, 3), np.float32)
    for i in range(n_samples):
        hi, (vx, vy) = _scene(rng, 9, 2 * h, 2 * w, return_motion=True)
        hr[i] = hi[1:8]
        lr[i] = hi[::2][:, ::2, ::2]  # every other frame, subsampled 2x
        # TRUE motion: the HR pattern translates (vx, vy) px per half-step;
        # one LR frame step = 2 half-steps at half resolution -> (vx, vy)
        # LR px forward, mirrored backward (physically consistent labels)
        fwd = np.array([vx, vy], np.float32)
        flow[i, 0::2] = fwd
        flow[i, 1::2] = -fwd
        flow_ss2[i, 0::2] = 2 * fwd
        flow_ss2[i, 1::2] = -2 * fwd
        warp[i] = lr[i, [0, 1, 1, 2, 2, 3, 3, 4]]  # frame-adjacent stand-ins
        warp_ss2[i] = lr[i, [0, 2, 2, 4]]
    return {
        "lr": lr, "hr": hr, "flow": flow, "flow_ss2": flow_ss2,
        "warp": warp, "warp_ss2": warp_ss2,
    }


def synthetic_store(n_samples: int = 8, h: int = 96, w: int = 96, seed: int = 0,
                    val_size: int = 2) -> TrainStore:
    a = synthetic_arrays(n_samples, h, w, seed)
    return TrainStore(
        data=_merge(a["lr"] / 255.0),
        label=_merge(a["hr"] / 255.0),
        flow=_merge(a["flow"] / h / 2.0),
        flow_ss2=_merge(a["flow_ss2"] / h / 2.0),
        warp=_merge(a["warp"] / 255.0),
        warp_ss2=_merge(a["warp_ss2"] / 255.0),
        val_size=val_size,
    )


def write_synthetic_corpus(folder: str, n_samples: int = 8, h: int = 96,
                           w: int = 96, seed: int = 0) -> dict:
    """Write a full on-disk corpus in the reference file formats; returns the
    path dict consumable by TrainStore.from_files."""
    os.makedirs(folder, exist_ok=True)
    a = synthetic_arrays(n_samples, h, w, seed)
    paths = {
        "data_path": os.path.join(folder, "LR_synth_5seq.mat"),
        "label_path": os.path.join(folder, "HR_synth_5seq.mat"),
        "flow_path": os.path.join(folder, "LR_synth_5seq_ss1.flo"),
        "flow_ss2_path": os.path.join(folder, "LR_synth_5seq_ss2.flo"),
        "warp_path": os.path.join(folder, "LR_synth_5seq_ss1_warp.mat"),
        "warp_ss2_path": os.path.join(folder, "LR_synth_5seq_ss2_warp.mat"),
    }
    matio.write_train_mat(paths["data_path"], "LR_data", a["lr"])
    matio.write_train_mat(paths["label_path"], "HR_data", a["hr"])
    flo_io.write_flo_5dim(a["flow"], paths["flow_path"])
    flo_io.write_flo_5dim(a["flow_ss2"], paths["flow_ss2_path"])
    matio.write_warp_mat(a["warp"], paths["warp_path"])
    matio.write_warp_mat(a["warp_ss2"], paths["warp_ss2_path"])
    return paths


def write_synthetic_test_set(folder: str, n_scenes: int = 1, h: int = 96,
                             w: int = 96, seed: int = 0) -> dict:
    """Write a reference-layout 4K-benchmark test set (scaled down): per
    scene 5 LR YUV PNGs + 7 HR YUV PNGs, plus the scene-stacked flow .flo
    [scenes, 8, h, w, 2] and warp .mat [scenes, 8, h, w, 3]."""
    from fisr_tpu_torch.data.png_io import write_png

    lr_dir = os.path.join(folder, "LR_LFR")
    hr_dir = os.path.join(folder, "HR_HFR")
    os.makedirs(lr_dir, exist_ok=True)
    os.makedirs(hr_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    flow = np.zeros((n_scenes, 8, h, w, 2), np.float32)
    warp = np.zeros((n_scenes, 8, h, w, 3), np.float32)
    for sc in range(n_scenes):
        hi = _scene(rng, 9, 2 * h, 2 * w)  # 9 half-step HR frames in [0,255]
        hr7 = hi[1:8]
        lr5 = hi[::2][:, ::2, ::2]
        for s in range(5):
            write_png(lr5[s].astype(np.uint8),
                      os.path.join(lr_dir, f"LR_scene{sc:02d}_seq_{s + 1}.png"))
        for s in range(7):
            write_png(hr7[s].astype(np.uint8),
                      os.path.join(hr_dir, f"HR_scene{sc:02d}_seq_{s + 1}.png"))
        flow[sc] = np.broadcast_to(
            rng.uniform(-3, 3, (8, 1, 1, 2)).astype(np.float32), (8, h, w, 2))
        warp[sc] = lr5[[0, 1, 1, 2, 2, 3, 3, 4]]
    paths = {
        "test_data_path": lr_dir,
        "test_label_path": hr_dir,
        "test_flow_data_path": os.path.join(folder, "LR_test_ss1.flo"),
        "test_warped_data_path": os.path.join(folder, "LR_test_ss1_warp.mat"),
    }
    flo_io.write_flo_5dim(flow, paths["test_flow_data_path"])
    matio.write_warp_mat(warp, paths["test_warped_data_path"])
    return paths


def synthetic_video_windows(n: int, h: int = 64, w: int = 64, seed: int = 0):
    """Joint fine-tuning batches on the serving-window contract.

    Returns (frames [N,3,h,w,3] YUV f32 in [0,255],
             targets [N,2h,2w,9] f32 in [0,1]) where target channels are
    the window's three output half-steps [VFI 2fr+1, SR 2fr+2, VFI 2fr+3]
    — the same LR<->HR half-step geometry as write_synthetic_video_scene
    (SR supervises the MIDDLE input frame's 2x image). Two windows per
    generated scene; scenes vary motion/frequency/phase via `seed`.
    """
    rng = np.random.default_rng(seed)
    frames, targets = [], []
    while len(frames) < n:
        hi = _scene(rng, 7, 2 * h, 2 * w)   # half-steps t = 0..6
        lr = hi[::2][:, ::2, ::2]           # input frames at t = 0,2,4,6
        for fr in range(2):                 # windows (0,1,2) and (1,2,3)
            frames.append(lr[fr : fr + 3])
            targets.append(np.concatenate(
                [hi[2 * fr + 1], hi[2 * fr + 2], hi[2 * fr + 3]], axis=-1))
    return (np.stack(frames[:n]).astype(np.float32),
            np.stack(targets[:n]).astype(np.float32) / 255.0)


def write_synthetic_video_folder(folder: str, n_frames: int = 3, h: int = 64,
                                 w: int = 64, seed: int = 0) -> str:
    """Write a FISR_for_video-style scene folder of YUV PNGs."""
    from fisr_tpu_torch.data.png_io import write_png

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    frames = _scene(rng, n_frames, h, w)
    for i in range(n_frames):
        write_png(frames[i].astype(np.uint8),
                  os.path.join(folder, f"LR_vid_fr_{i:03d}.png"))
    return folder


def write_synthetic_video_scene(folder: str, n_frames: int = 5, h: int = 64,
                                w: int = 64, seed: int = 0):
    """LR video folder WITH its high-res high-frame-rate ground truth.

    The reference's FISR_for_video phase is GT-free (it upconverts arbitrary
    footage, FISRnet.py:937-1084), so the video pipeline's end quality was
    never directly measurable. This writes a physically-consistent pair:
    HR half-step frames at (2h, 2w) under `folder/HR_GT/`, and the LR
    input = every other HR frame subsampled 2x (the same LR<->HR contract
    as `synthetic_arrays`).

    Index alignment (what `infer.video_eval.evaluate_video_folder` relies
    on): window fr reads LR frames fr, fr+1, fr+2 = HR half-steps 2fr,
    2fr+2, 2fr+4 and its three outputs are half-steps 2fr+1 (VFI), 2fr+2
    (SR of the MIDDLE input frame), 2fr+3 (VFI) — the same
    `s -> label 2*sample_i+s over hr=hi[1:8]` mapping the test phase
    scores with (infer/evaluate.py; reference FISRnet.py:913-920 via its
    7-frame GT hi[1:8]). The pipeline numbers output files `fr*2+s`
    (FISRnet.py:1063-1077), so pred file k depicts half-step k+1: GT file
    `HR_YUV_{k}.png` is written as `hi[k+1]` for k in 0..2*n_frames-4,
    and SR frames sit at ODD k (even half-steps = input-frame times).

    Returns (lr_folder, gt_folder).
    """
    from fisr_tpu_torch.data.png_io import write_png

    os.makedirs(folder, exist_ok=True)
    gt_dir = os.path.join(folder, "HR_GT")
    os.makedirs(gt_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    hi = _scene(rng, 2 * n_frames - 1, 2 * h, 2 * w)  # YUV half-steps [0,255]
    lr = hi[::2][:, ::2, ::2]
    # same zero-pad width as run_video_pipeline's output numbering
    digits = max(1, int(np.ceil(np.log10(2 * (n_frames - 1)))))
    for i in range(n_frames):
        write_png(lr[i].astype(np.uint8),
                  os.path.join(folder, f"LR_vid_fr_{i:03d}.png"))
    for k in range(2 * n_frames - 3):  # pred file indices 0 .. 2n-4
        write_png(hi[k + 1].astype(np.uint8),
                  os.path.join(gt_dir, f"HR_YUV_{str(k).zfill(digits)}.png"))
    return folder, gt_dir
