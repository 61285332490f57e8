#!/usr/bin/env python3
"""The fused main path of fisr_tpu_torch on a trained PWC-Net, on one CUDA
card, beside the same path on the TF-oracle generator's PWC-Net.

    python3 scripts/time_torch_trained.py [--pwc_ckpt DIR]

`--pwc_ckpt` is a checkpoint directory that the port's CLI restores (default
./checkpoint_dir/pwcnet, the JAX package's trained orbax store). Both runs go
through chip_smoke.trained_main_path on 4 synthetic 1024x1920 frames with the
full-width deterministic FISRnet, bf16: 15 cost-volume launches each, the
steady window's (a pair + a window) time and spread, and an f32 flow of a
256x448 crop, card against CPU. Prints the card's name and power limit; the
last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pwc_ckpt", default=os.path.join(ROOT, "checkpoint_dir", "pwcnet"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_trained: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from fisr_tpu_torch.cli import main as cli
    from fisr_tpu_torch.convert import params
    from fisr_tpu_torch.data.png_io import write_png

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.phase_build()
    fisr = params.deterministic_fisrnet(ch=64, device="cuda")
    runs = {"trained": cli._model(cli.parse_args(["--pwc_ckpt", args.pwc_ckpt]), "cuda", "pwc"),
            "generator": params.deterministic_pwcnet(device="cuda")}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "scene1")
        os.makedirs(folder)
        for i, fr in enumerate(chip_smoke.synthetic_frames(4, *chip_smoke.WINDOW)):
            write_png(fr, os.path.join(folder, f"frame_{i:03d}.png"))
        for name, pwc in runs.items():
            work = os.path.join(tmp, name)
            os.makedirs(work)
            out[name] = chip_smoke.trained_main_path(fisr, pwc, folder, work, f"{name} PWC-Net")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"pwc_ckpt": args.pwc_ckpt, "device": torch.cuda.get_device_name(0), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
