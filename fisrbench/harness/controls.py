"""The controls that the limits of `correct` are set against: the reference
put in the program's place, computed one precision below what the
configuration states (`lower`), and judged by the driver's own check.

Each traffic driver exports `control(ctx, numerics)`, which makes what the
timed path would have produced with the reference in the program's place
and returns the driver's `check` of it: ([(name, value, limit)], failed).
`runner.judged` decides it as it decides a run; a control has to come out
not correct. The benchmark's own runs never run these. On
the card, at a cell's size:

    python3 -m fisrbench.harness.controls --workload <cell> --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def lower(config: dict) -> str:
    """The reference's numerics (reference/ops.Numerics) one precision below
    the configuration's: fp8 below bfloat16, TF32 below float32 with TF32
    off."""
    dtype = config["compute_dtype"]
    if dtype == "bfloat16":
        return "fp8"
    if dtype == "float32" and not config.get("tf32"):
        return "tf32"
    raise ValueError(f"no control below compute_dtype {dtype!r}, tf32 {config.get('tf32')!r}")


def main(argv=None) -> int:
    from fisrbench.harness.manifest import Manifest
    from fisrbench.harness.runner import RunContext, judged

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    m = Manifest()
    cell = m.cell(args.workload)
    mix, config = m.mix(cell["traffic"]), m.config(cell["config"])
    for seed in args.seeds:
        ctx = RunContext(cell=cell, config=config, mix=mix, seed=seed, seconds=0.0, trace=False,
                         device=torch.device("cuda", 0), t_start=time.perf_counter())
        t0 = time.perf_counter()
        checks, failed = m.driver(mix).control(ctx, lower(config))
        print(json.dumps({"workload": args.workload, "seed": seed, "numerics": lower(config),
                          "checked": {n: {"value": v, "limit": lim} for n, v, lim in checks},
                          "failed": failed, "correct": judged(checks, failed),
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
