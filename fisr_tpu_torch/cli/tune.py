"""One-shot autotune: measure the fastest FISRnet tiling plan on this card.

    python -m fisr_tpu_torch.cli.tune --height 1024 --width 1920 --dtype bfloat16

Port of fisr_tpu/cli/tune.py. Times every 32-multiple-preserving grid of
that window size, and the grids a small edge pad unlocks, on the card
(infer/autotune.sweep: CUDA events, medians), writes the table to the tune
cache (~/.cache/fisr_tpu_torch/autotune.json by default) and prints the
winner as one JSON line. Serving and the video phase pick it up through
`--fisr_grid tuned`. FISRnet is the fresh init at full width (timing does
not depend on the weights), cast to bf16 under --dtype bfloat16 as serving
casts it.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, required=True,
                   help="input window height (32-multiple, e.g. 1024)")
    p.add_argument("--width", type=int, required=True,
                   help="input window width (32-multiple, e.g. 1920)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--boundary", type=int, default=32)
    p.add_argument("--reps", type=int, default=3,
                   help="timed passes per candidate (median)")
    p.add_argument("--cache", default=None,
                   help="tune-cache path (default ~/.cache/fisr_tpu_torch/autotune.json)")
    p.add_argument("--max_gh", type=int, default=6, help="largest grid height swept")
    p.add_argument("--max_gw", type=int, default=8, help="largest grid width swept")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' times the plain versions on the CPU")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from fisr_tpu_torch.device import f32_scope
    from fisr_tpu_torch.infer.autotune import DEFAULT_CACHE_PATH, TuneCache
    from fisr_tpu_torch.models.fisrnet import FISRnet
    from fisr_tpu_torch.ops.conv import BF16, F32

    policy = BF16 if args.dtype == "bfloat16" else F32
    model = FISRnet(seed=0, device=args.device)
    if args.dtype == "bfloat16":
        model = model.to(torch.bfloat16)  # serving casts once at load

    cache = TuneCache(args.cache or DEFAULT_CACHE_PATH, device=args.device)
    # --dtype float32 times the plans without TF32, as serving runs them
    with f32_scope(policy):
        grid = cache.tune(model, args.height, args.width, policy=policy, boundary=args.boundary,
                          reps=args.reps, max_gh=args.max_gh, max_gw=args.max_gw, verbose=True)
    plan = cache.best_plan(args.height, args.width, args.dtype, args.boundary)
    rec = {
        # None when every pad-free candidate ran out of memory: the frame is
        # then servable only through best_plan's padded winner
        "best_grid": list(grid) if grid is not None else None,
        # the overall winner, padded candidates included (what
        # fisr_grid='tuned' serves through video.resolve_fisr_plan)
        "best_plan": {"grid": list(plan[0]), "pad": list(plan[1])},
        "frame": [args.height, args.width],
        "dtype": args.dtype,
        "device_kind": TuneCache._device_kind(args.device),
        "cache": cache.path,
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
