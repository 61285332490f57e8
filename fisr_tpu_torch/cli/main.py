"""CLI: `python -m fisr_tpu_torch.cli.main --phase {test,FISR_for_video}`.

The inference phases of fisr_tpu/cli/main.py on the port, with the JAX CLI's
flag names and defaults:

  test           - 4K benchmark evaluation from precomputed .flo / .mat
                   inputs (--eval_engine exact|fast, --ssim_impl, --test_patch,
                   --test_input_size, the --test_*_path flags, --test_img_dir)
  FISR_for_video - flow -> warp -> FISRnet over a folder of YUV PNGs: staged
                   by default (--FISR_test_patch; writes the .flo / .mat
                   artifacts), on the device with --fused (--fisr_grid
                   full|auto|tuned|GH,GW)

Weights come from .npz files of '/'-joined JAX key paths -> arrays
(--fisr_params_npz, --pwc_params_npz) or from the TF-oracle generator at full
width (--deterministic_weights); one of the two is required for each model
the phase uses. The train phase is not ported yet (ROADMAP.md, Queue 1
item 4) and raises.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="FISR on PyTorch/CUDA: joint 2x frame interpolation + 2x super-resolution")
    p.add_argument("--phase", type=str, default="FISR_for_video",
                   choices=["train", "test", "FISR_for_video"])
    p.add_argument("--scale_factor", type=int, default=2)
    p.add_argument("--ssim_impl", type=str, default="gaussian", choices=["gaussian", "pil"],
                   help="test-phase SSIM scorer: the standard Gaussian SSIM, or 'pil' = the "
                        "reference's SSIM_PIL tile algorithm (FISRnet.py:890-891)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="activation dtype (params always f32)")
    p.add_argument("--eval_engine", type=str, default="exact", choices=["exact", "fast"],
                   help="test-phase inference engine: 'exact' reproduces the reference's "
                        "patch tiling (host-staged TiledRunner); 'fast' runs the device "
                        "tiling (padded tiling + stale-halo shrink + folded upsample)")

    # test phase
    p.add_argument("--test_data_path", type=str, default="./data/test/LR_LFR")
    p.add_argument("--test_flow_data_path", type=str,
                   default="./data/test/flow/LR_Surfing_SlamDunk_test_ss1.flo")
    p.add_argument("--test_warped_data_path", type=str,
                   default="./data/test/warped/LR_Surfing_SlamDunk_test_ss1_warp.mat")
    p.add_argument("--test_label_path", type=str, default="./data/test/HR_HFR")
    p.add_argument("--test_img_dir", type=str, default="./test_img_dir")
    p.add_argument("--exp_num", type=int, default=1,
                   help="predictions go to <test_img_dir>/FISRnet_exp<exp_num>")
    p.add_argument("--test_patch", type=int, nargs=2, default=[2, 2])
    p.add_argument("--test_input_size", type=int, nargs=2, default=[1080, 1920])

    # FISR_for_video
    p.add_argument("--frame_folder_path", type=str, default="./FISR_test_folder/scene1")
    p.add_argument("--video_out_dir", type=str, default=None,
                   help="output frame folder (default: <frame_folder>/FISR_frames)")
    p.add_argument("--frame_num", type=int, default=5)
    p.add_argument("--FISR_test_patch", type=int, nargs=2, default=[2, 2],
                   help="patch grid of the staged video path's FISRnet stage")
    p.add_argument("--flow_scale", type=int, default=2, choices=[1, 2],
                   help="flow-stage input scale: 2 = reference parity (x2 upscale "
                        "before PWC-Net), 1 = flow at native resolution")
    p.add_argument("--fused", action="store_true",
                   help="run the video phase on the device, flow -> warp -> FISRnet "
                        "per window (no .flo / .mat round trip)")
    p.add_argument("--fisr_grid", type=str, default="full",
                   help="FISRnet tiling of the fused window stage: 'full' (no tiling, the "
                        "reference's video phase), 'auto' (infer/device.padded_grid), "
                        "'tuned' (autotune cache: not ported, raises) or 'GH,GW'")

    # weights and device
    p.add_argument("--fisr_params_npz", type=str, default=None,
                   help="FISRnet weights: .npz of '/'-joined key paths -> arrays "
                        "(the JAX package's param tree)")
    p.add_argument("--pwc_params_npz", type=str, default=None,
                   help="PWC-Net (lg-6-2) weights, same format")
    p.add_argument("--deterministic_weights", action="store_true",
                   help="full-width weights from the TF-oracle generator "
                        "(convert/oracle.py) for any model without an .npz")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions on the CPU")
    return p.parse_args(argv)


def _model(args, device, what):
    from fisr_tpu_torch.convert import params

    npz = getattr(args, f"{what}_params_npz")
    from_jax, deterministic = {
        "fisr": (params.fisrnet_from_jax, params.deterministic_fisrnet),
        "pwc": (params.pwcnet_from_jax, params.deterministic_pwcnet)}[what]
    if npz:
        return from_jax(params.tree_from_npz(npz), device=device)
    if args.deterministic_weights:
        return deterministic(device=device)
    raise SystemExit(f"no {what} weights: pass --{what}_params_npz or --deterministic_weights")


def _policy(args):
    from fisr_tpu_torch.ops.conv import BF16, F32

    return BF16 if args.compute_dtype == "bfloat16" else F32


def run_test(args, device):
    from fisr_tpu_torch.infer.device import FastTiledRunner
    from fisr_tpu_torch.infer.evaluate import evaluate_test_set
    from fisr_tpu_torch.infer.tiled import TiledRunner

    make = FastTiledRunner if args.eval_engine == "fast" else TiledRunner
    runner = make(_model(args, device, "fisr"), grid=tuple(args.test_patch), boundary=32,
                  sf=args.scale_factor, policy=_policy(args), device=device)
    return evaluate_test_set(
        runner, args.test_data_path, args.test_label_path, args.test_flow_data_path,
        args.test_warped_data_path,
        out_dir=os.path.join(args.test_img_dir, f"FISRnet_exp{args.exp_num}"),
        input_size=tuple(args.test_input_size), ssim_impl=args.ssim_impl)


def run_video(args, device):
    from fisr_tpu_torch.cli._common import parse_grid
    from fisr_tpu_torch.infer.video import run_video_pipeline

    out = run_video_pipeline(
        _model(args, device, "fisr"), _model(args, device, "pwc"), args.frame_folder_path,
        out_folder=args.video_out_dir, grid=tuple(args.FISR_test_patch), policy=_policy(args),
        write_artifacts=not args.fused, frame_num=args.frame_num, fused=args.fused,
        flow_upscale=args.flow_scale, fisr_grid=parse_grid(args.fisr_grid), device=device)
    print(f"[*] FISR_for_video finished: {len(out)} frames")
    return out


def main(argv=None):
    args = parse_args(argv)
    if args.phase == "train":
        raise NotImplementedError("phase 'train' is not ported yet (ROADMAP.md, Queue 1 item 4)")
    from fisr_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    # the runners, the pipeline's stages and the metrics turn autograd off themselves
    return run_test(args, device) if args.phase == "test" else run_video(args, device)


if __name__ == "__main__":
    main()
