"""CLI: `python -m fisr_tpu_torch.cli.main --phase {train,test,FISR_for_video}`.

The phases of fisr_tpu/cli/main.py on the port, with the JAX CLI's flag names
and defaults (the reference's own main.py:23-106):

  train          - fit on the .mat / .flo corpus (the --train_*_path flags,
                   read by data/matio's own HDF5 codec), checkpoints under
                   <checkpoint_dir>/FISRnet_exp<exp_num>, then the test phase
  test           - 4K benchmark evaluation from precomputed .flo / .mat
                   inputs (--eval_engine exact|fast, --ssim_impl, --test_patch,
                   --test_input_size, the --test_*_path flags, --test_img_dir)
  FISR_for_video - flow -> warp -> FISRnet over a folder of YUV PNGs: staged
                   by default (--FISR_test_patch; writes the .flo / .mat
                   artifacts), on the device with --fused (--fisr_grid
                   full|auto|tuned|GH,GW)

FISRnet weights named by a flag win: --fisr_tf_ckpt (a TF1 TensorBundle
prefix, the released FISRnet-122000's format), then --fisr_params_npz (an .npz
of '/'-joined JAX key paths -> arrays), then the TF-oracle generator at full
width (--deterministic_weights). Without any they come from the experiment's
newest checkpoint (<checkpoint_dir>/FISRnet_exp<exp_num>, what the train
phase writes), else a fresh init, said aloud (the JAX CLI's `_load_params`).
The test that ends the train phase scores the checkpoint it just wrote.
PWC-Net weights come from --pwc_tf_ckpt, --pwc_params_npz or the generator,
else from the best step (least validation EPE) of a checkpoint directory:
--pwc_ckpt, or by default <checkpoint_dir>/pwcnet (what
`train.pwc_trainer.pwc_fit` writes, and where the repo keeps the JAX
package's trained PWC-Net; the JAX CLI's `_load_pwc_params`); without any the
run stops. A checkpoint directory may hold steps of the port (tree.npz) or
of the JAX package (orbax, read by convert/orbax_read.py without
tensorstore). The JAX CLI's
--jax_cache_dir has no counterpart (nothing is compiled ahead of a run); every
other flag of it parses here with its default.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="FISR on PyTorch/CUDA: joint 2x frame interpolation + 2x super-resolution")
    p.add_argument("--net_type", type=str, default="FISRnet", choices=["FISRnet"])
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

    # training corpus, directories
    p.add_argument("--train_data_path", type=str,
                   default="./data/train/LR_LFR/LR_Surfing_SlamDunk_5seq.mat")
    p.add_argument("--train_flow_data_path", type=str,
                   default="./data/train/flow/LR_Surfing_SlamDunk_5seq_ss1.flo")
    p.add_argument("--train_flow_ss2_data_path", type=str,
                   default="./data/train/flow/LR_Surfing_SlamDunk_5seq_ss2.flo")
    p.add_argument("--train_warped_data_path", type=str,
                   default="./data/train/warped/LR_Surfing_SlamDunk_5seq_ss1_warp.mat")
    p.add_argument("--train_wapred_ss2_data_path", type=str,
                   default="./data/train/warped/LR_Surfing_SlamDunk_5seq_ss2_warp.mat")
    p.add_argument("--train_label_path", type=str,
                   default="./data/train/HR_HFR/HR_Surfing_SlamDunk_5seq.mat")
    p.add_argument("--text_dir", type=str, default="./text_dir")
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoint_dir")
    p.add_argument("--log_dir", type=str, default="./logdir")

    # training hyperparameters (main.py:64-77)
    p.add_argument("--epoch", type=int, default=100)
    p.add_argument("--freq_display", type=int, default=100)
    p.add_argument("--step_timeout_s", type=float, default=0.0,
                   help="arm the utils.watchdog heartbeat: exit 86 if no train/val step "
                        "completes within this window, so a supervisor restarts the "
                        "process and training resumes from the last checkpoint. 0 = off")
    p.add_argument("--init_lr", type=float, default=1e-4)
    p.add_argument("--lr_type", type=str, default="stair_decay",
                   choices=["linear_decay", "stair_decay", "no_decay"])
    p.add_argument("--lr_stair_decay_points", type=int, nargs="+", default=[80, 90])
    p.add_argument("--lr_decreasing_factor", type=float, default=0.1)
    p.add_argument("--lr_linear_decay_point", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--val_batch_size", type=int, default=2)
    p.add_argument("--val_data_size", type=int, default=320)

    # loss lambdas (main.py:80-85)
    p.add_argument("--recn_lambda", type=float, default=1.0)
    p.add_argument("--tm1_lambda", type=float, default=1.0)
    p.add_argument("--tm2_lambda", type=float, default=0.1)
    p.add_argument("--tmm_lambda", type=float, default=1.0)
    p.add_argument("--td_lambda", type=float, default=0.1)
    p.add_argument("--ss2_lambda", type=float, default=1.0)

    # test phase
    p.add_argument("--test_data_path", type=str, default="./data/test/LR_LFR")
    p.add_argument("--test_flow_data_path", type=str,
                   default="./data/test/flow/LR_Surfing_SlamDunk_test_ss1.flo")
    p.add_argument("--test_warped_data_path", type=str,
                   default="./data/test/warped/LR_Surfing_SlamDunk_test_ss1_warp.mat")
    p.add_argument("--test_label_path", type=str, default="./data/test/HR_HFR")
    p.add_argument("--test_img_dir", type=str, default="./test_img_dir")
    p.add_argument("--exp_num", type=int, default=1,
                   help="names the experiment: FISRnet_exp<exp_num> under checkpoint_dir, "
                        "log_dir and test_img_dir, and text_dir/exp_<exp_num>.txt")
    p.add_argument("--test_patch", type=int, nargs=2, default=[2, 2])
    p.add_argument("--test_input_size", type=int, nargs=2, default=[1080, 1920])

    # FISR_for_video
    p.add_argument("--frame_folder_path", type=str, default="./FISR_test_folder/scene1")
    p.add_argument("--video_out_dir", type=str, default=None,
                   help="output frame folder (default: <frame_folder>/FISR_frames)")
    p.add_argument("--FISR_input_size", type=int, nargs=2, default=[1080, 1920],
                   help="accepted for the reference's command lines; the video phase "
                        "takes its size from the frames")
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
                        "'tuned' (this card's plan in the autotune cache, see "
                        "`python -m fisr_tpu_torch.cli.tune`; 'auto' where untuned) or 'GH,GW'")

    # weights and device
    p.add_argument("--fisr_params_npz", type=str, default=None,
                   help="FISRnet weights: .npz of '/'-joined key paths -> arrays "
                        "(the JAX package's param tree)")
    p.add_argument("--pwc_params_npz", type=str, default=None,
                   help="PWC-Net (lg-6-2) weights, same format")
    p.add_argument("--pwc_ckpt", type=str, default=None,
                   help="PWC-Net checkpoint directory (what pwc_fit writes); default: "
                        "<checkpoint_dir>/pwcnet where it holds a checkpoint")
    p.add_argument("--fisr_tf_ckpt", type=str, default=None,
                   help="TF1 TensorBundle prefix for FISRnet (e.g. .../FISRnet-122000); "
                        "wins over every other FISRnet weight source")
    p.add_argument("--pwc_tf_ckpt", type=str, default=None,
                   help="TF1 TensorBundle prefix for PWC-Net (e.g. .../pwcnet.ckpt-595000); "
                        "wins over every other PWC-Net weight source")
    p.add_argument("--deterministic_weights", action="store_true",
                   help="full-width weights from the TF-oracle generator "
                        "(convert/oracle.py) for any model without an .npz")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions on the CPU")
    return p.parse_args(argv)


def _model_dir(args) -> str:
    return f"FISRnet_exp{args.exp_num}"


def _model(args, device, what):
    """The `what` ('fisr' or 'pwc') model on `device`, from the weight flags
    in `args` (flags another parser lacks read as unset; cli/serve uses it)."""
    from fisr_tpu_torch.convert import params

    from_jax, deterministic, tf_model, title = {
        "fisr": (params.fisrnet_from_jax, params.deterministic_fisrnet, "fisrnet", "FISRnet"),
        "pwc": (params.pwcnet_from_jax, params.deterministic_pwcnet, "pwcnet", "PWC-Net")}[what]
    tf_ckpt = getattr(args, f"{what}_tf_ckpt", None)
    if tf_ckpt:
        from fisr_tpu_torch.convert.tf_import import load_tf_checkpoint

        model = from_jax(load_tf_checkpoint(tf_ckpt, tf_model), device=device)
        print(f" [*] imported TF1 {title} checkpoint {tf_ckpt}")
        return model
    npz = getattr(args, f"{what}_params_npz")
    if npz:
        return from_jax(params.tree_from_npz(npz), device=device)
    if args.deterministic_weights:
        return deterministic(device=device)
    tree = _restore(args, what)
    if tree is not None:
        return from_jax(tree["params"] if "params" in tree else tree, device=device)
    if what == "fisr":
        from fisr_tpu_torch.models.fisrnet import FISRnet

        print(" [!] no checkpoint found: using fresh init")
        return FISRnet(sf=getattr(args, "scale_factor", 2), device=device)
    raise SystemExit(f"no {what} weights: pass --{what}_tf_ckpt, --{what}_params_npz, "
                     "--pwc_ckpt or --deterministic_weights")


def _restore(args, what):
    """The checkpoint tree for `what`, or None where there is none: FISRnet's
    newest step of the experiment, PWC-Net's best step (least metric) of
    --pwc_ckpt or <checkpoint_dir>/pwcnet; steps of the port or of the JAX
    package's orbax manager (train/checkpoint.CheckpointManager.restore)."""
    from fisr_tpu_torch.train.checkpoint import CheckpointManager

    if what == "fisr":
        path = os.path.join(args.checkpoint_dir, _model_dir(args))
    else:
        path = args.pwc_ckpt or os.path.join(args.checkpoint_dir, "pwcnet")
    if os.path.isdir(path):
        mgr = CheckpointManager(path, best_mode=None if what == "fisr" else "min")
        if mgr.latest_step() is not None:
            step = mgr.latest_step() if what == "fisr" else mgr.best_step()
            tree = mgr.restore(step)
            print(f" [*] restored checkpoint step {step}" if what == "fisr"
                  else f" [*] restored PWC-Net checkpoint step {step} from {path}")
            return tree
    if what == "pwc" and args.pwc_ckpt:
        raise FileNotFoundError(f"--pwc_ckpt {args.pwc_ckpt}: no checkpoint found")
    return None


def _policy(args):
    from fisr_tpu_torch.ops.conv import BF16, F32

    return BF16 if args.compute_dtype == "bfloat16" else F32


def run_train(args, device):
    from fisr_tpu_torch.data.dataset import TrainStore
    from fisr_tpu_torch.models.fisrnet import FISRnet
    from fisr_tpu_torch.train.loop import fit
    from fisr_tpu_torch.train.losses import LossWeights
    from fisr_tpu_torch.utils.summary import print_params

    for d in (args.checkpoint_dir, args.text_dir, args.log_dir):
        os.makedirs(d, exist_ok=True)
    # arg dump parity (main.py:131-134)
    with open(os.path.join(args.text_dir, f"exp_{args.exp_num}.txt"), "a") as log:
        log.write("----- Model parameters -----\n")
        for k, v in vars(args).items():
            log.write(f"{k} : {v}\n")
    print_params(FISRnet(device="cpu"), name="FISRnet")

    store = TrainStore.from_files(
        args.train_data_path, args.train_label_path, args.train_flow_data_path,
        args.train_flow_ss2_data_path, args.train_warped_data_path,
        args.train_wapred_ss2_data_path, val_size=args.val_data_size)
    weights = LossWeights(recn=args.recn_lambda, tm1=args.tm1_lambda, tm2=args.tm2_lambda,
                          tmm=args.tmm_lambda, td=args.td_lambda, ss2=args.ss2_lambda)
    return fit(store,
               ckpt_dir=os.path.join(args.checkpoint_dir, _model_dir(args)),
               log_dir=os.path.join(args.log_dir, _model_dir(args)),
               epochs=args.epoch, batch_size=args.batch_size,
               val_batch_size=args.val_batch_size, init_lr=args.init_lr,
               lr_type=args.lr_type, lr_stair_decay_points=args.lr_stair_decay_points,
               lr_decreasing_factor=args.lr_decreasing_factor,
               lr_linear_decay_point=args.lr_linear_decay_point,
               loss_weights=weights, freq_display=args.freq_display,
               policy=_policy(args), step_timeout_s=args.step_timeout_s or None,
               device=device)


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
        out_dir=os.path.join(args.test_img_dir, _model_dir(args)),
        input_size=tuple(args.test_input_size), ssim_impl=args.ssim_impl)


def run_video(args, device):
    from fisr_tpu_torch.cli._common import parse_grid
    from fisr_tpu_torch.infer.video import run_video_pipeline

    return run_video_pipeline(
        _model(args, device, "fisr"), _model(args, device, "pwc"), args.frame_folder_path,
        out_folder=args.video_out_dir, grid=tuple(args.FISR_test_patch), policy=_policy(args),
        write_artifacts=not args.fused, frame_num=args.frame_num, fused=args.fused,
        flow_upscale=args.flow_scale, fisr_grid=parse_grid(args.fisr_grid), device=device)


def main(argv=None):
    args = parse_args(argv)
    from fisr_tpu_torch.device import f32_scope, resolve_device

    device = resolve_device(args.device)
    print(f"Model: {args.net_type}, phase: {args.phase}, exp: {args.exp_num}")
    # --compute_dtype float32: the whole phase without TF32 (fisr_tpu_torch/device.py)
    with f32_scope(_policy(args)):
        if args.phase == "train":
            run_train(args, device)
            print("[*] Training finished! Testing starts")
            # the trained weights, whatever weights the flags name
            args.fisr_params_npz, args.deterministic_weights = None, False
            result = run_test(args, device)
        elif args.phase == "test":
            # the runners, the pipeline's stages and the metrics turn autograd off themselves
            result = run_test(args, device)
        else:
            result = run_video(args, device)
    print(f"[*] {args.phase} finished!")
    return result


if __name__ == "__main__":
    main()
