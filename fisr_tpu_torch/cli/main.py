"""CLI: `python -m fisr_tpu_torch.cli.main --phase FISR_for_video --fused`.

The FISR_for_video phase of fisr_tpu/cli/main.py on the port, with the JAX
CLI's flag names for that phase. Weights come from .npz files of
'/'-joined JAX key paths -> arrays (--fisr_params_npz, --pwc_params_npz) or
from the TF-oracle generator at full width (--deterministic_weights); one of
the two is required. The train and test phases and the staged video path
are not ported yet (ROADMAP.md, Queue 1) and raise.
"""

from __future__ import annotations

import argparse

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="FISR on PyTorch/CUDA: joint 2x frame interpolation + 2x super-resolution")
    p.add_argument("--phase", type=str, default="FISR_for_video",
                   choices=["train", "test", "FISR_for_video"])
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="activation dtype (params always f32)")
    p.add_argument("--frame_folder_path", type=str, default="./FISR_test_folder/scene1")
    p.add_argument("--video_out_dir", type=str, default=None,
                   help="output frame folder (default: <frame_folder>/FISR_frames)")
    p.add_argument("--frame_num", type=int, default=5)
    p.add_argument("--flow_scale", type=int, default=2, choices=[1, 2],
                   help="flow-stage input scale: 2 = reference parity (x2 upscale "
                        "before PWC-Net), 1 = flow at native resolution")
    p.add_argument("--fused", action="store_true",
                   help="run the video phase on the device, flow -> warp -> FISRnet "
                        "per window (the only video path ported)")
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


def _models(args, device):
    from fisr_tpu_torch.convert import params

    def one(npz, from_jax, deterministic, what):
        if npz:
            return from_jax(params.tree_from_npz(npz), device=device)
        if args.deterministic_weights:
            return deterministic(device=device)
        raise SystemExit(f"no {what} weights: pass --{what}_params_npz or --deterministic_weights")

    return (one(args.fisr_params_npz, params.fisrnet_from_jax, params.deterministic_fisrnet, "fisr"),
            one(args.pwc_params_npz, params.pwcnet_from_jax, params.deterministic_pwcnet, "pwc"))


def main(argv=None):
    args = parse_args(argv)
    if args.phase != "FISR_for_video":
        raise NotImplementedError(f"phase {args.phase!r} is not ported yet (ROADMAP.md, Queue 1)")
    if not args.fused:
        raise NotImplementedError("only the fused video path is ported: pass --fused "
                                  "(the staged path waits, ROADMAP.md, Queue 1)")
    import torch

    from fisr_tpu_torch.device import resolve_device
    from fisr_tpu_torch.infer.video import run_video_pipeline
    from fisr_tpu_torch.ops.conv import BF16, F32

    device = resolve_device(args.device)
    fisr_model, pwc_model = _models(args, device)
    policy = BF16 if args.compute_dtype == "bfloat16" else F32
    with torch.inference_mode():
        out = run_video_pipeline(fisr_model, pwc_model, args.frame_folder_path,
                                 out_folder=args.video_out_dir, policy=policy,
                                 frame_num=args.frame_num, fused=True,
                                 flow_upscale=args.flow_scale, device=device)
    print(f"[*] FISR_for_video finished: {len(out)} frames")
    return out


if __name__ == "__main__":
    main()
