"""Checkpoint conversion CLI (port of fisr_tpu/convert/cli.py): a TF1
checkpoint, an .npz dump of one, or a JAX orbax step -> a checkpoint of the
port (`<out>/step_<N>/tree.npz`, train/checkpoint.CheckpointManager).

  python -m fisr_tpu_torch.convert.cli --model fisrnet \\
      --ckpt ./checkpoint_dir/FISRnet_exp1/FISRnet-122000 \\
      --out ./checkpoint_dir/FISRnet_exp1 --step 122000

`--ckpt` is a TF1 TensorBundle prefix (the released FISRnet-122000 and
pwcnet.ckpt-595000), read without TensorFlow (convert/tensor_bundle.py);
`--npz` a {tf_var_name: array} dump made anywhere with TF. Both are checked
against a fresh module's key set and shapes (convert/tf_import.py).

`--orbax <step_dir>` is the port's own source: a step the JAX package's
orbax manager wrote. Reading it needs `tensorstore`; the converted directory
then restores on a machine without it. Its params are checked the same way.

After conversion, `--phase test` / `--phase FISR_for_video` (cli/main.py)
restore it like any checkpoint of the port.
"""

from __future__ import annotations

import argparse

import numpy as np

__all__ = ["main"]


def main(argv=None):
    from fisr_tpu_torch.convert import tf_import
    from fisr_tpu_torch.convert.orbax_read import read_orbax_tree
    from fisr_tpu_torch.convert.params import flatten_tree
    from fisr_tpu_torch.train.checkpoint import CheckpointManager

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=["fisrnet", "pwcnet"], required=True)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="TF checkpoint prefix (e.g. .../FISRnet-122000)")
    src.add_argument("--npz", help=".npz of {tf_var_name: array}")
    src.add_argument("--orbax", help="step directory of a JAX orbax checkpoint "
                                     "(e.g. .../pwcnet/step_14000); needs tensorstore")
    p.add_argument("--out", required=True, help="checkpoint directory of the port")
    p.add_argument("--step", type=int, default=0,
                   help="global step to key the checkpoint on (e.g. 122000)")
    p.add_argument("--verify-crc", action="store_true",
                   help="check per-tensor/block crc32c while reading --ckpt")
    args = p.parse_args(argv)

    if args.ckpt:
        params = tf_import.load_tf_checkpoint(args.ckpt, args.model, verify_crc=args.verify_crc)
    elif args.npz:
        with np.load(args.npz) as z:
            tf_vars = tf_import.normalize_tf_vars(dict(z))
        params = tf_import.check_tree(
            tf_import.convert_fisrnet(tf_vars) if args.model == "fisrnet"
            else tf_import.convert_pwcnet(tf_vars), args.model)
    else:
        tree = read_orbax_tree(args.orbax)
        params = tf_import.check_tree(tree["params"] if "params" in tree else tree, args.model)

    CheckpointManager(args.out).save(args.step, {"params": params})
    n = sum(int(np.prod(np.shape(v))) for _, v in flatten_tree(params))
    print(f"[*] wrote step {args.step} ({n:,} params) to {args.out}")


if __name__ == "__main__":
    main()
