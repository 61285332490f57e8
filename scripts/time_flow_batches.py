#!/usr/bin/env python3
"""Host time of FlowDataset's training batches: the fused native pass
against its plain numpy version, with the same draws.

    python3 scripts/time_flow_batches.py [--samples 64] [--hw 384 512] [--crop 256 448]
                                         [--batch 8] [--batches 8] [--seed 0]

Builds `samples` random u8 pairs and f32 flows of `hw`, then assembles
`batches` training batches of `batch` random crops with the default
augmentation (`AugmentOptions()`: flips, shift and resize, each p = 0.5)
twice from the same seeds: by `FlowDataset.batches` (crop, augmentation and
/ 255 in `native.flow_sample`, on the host's cores), and by the same draws
handed to its plain version (data/augment.apply_plan in numpy). Checks each
batch bit for bit and prints ms a batch (median, min, max) of each with the
CPU's name and cores. The last line is one JSON object. CPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.realpath(__file__))))

from fisr_tpu_torch import native  # noqa: E402
from fisr_tpu_torch.data.augment import AugmentOptions  # noqa: E402
from fisr_tpu_torch.data.flow_dataset import FlowDataset  # noqa: E402


def plain_batches(ds: FlowDataset, batch: int, n: int, epoch_seed: int):
    """(batch, ms) of the first n training batches, ds's draws assembled by
    the plain version of native.flow_sample."""
    plain = native.plain_versions()["flow_sample"]
    order = np.random.default_rng(epoch_seed).permutation(ds._train_idx)
    ch, cw = ds.crop_hw
    for k in range(n):
        t0 = time.perf_counter()
        x = np.empty((batch, 2, ch, cw, 3), np.float32)
        y = np.empty((batch, ch, cw, 2), np.float32)
        for s, j in enumerate(order[k * batch:(k + 1) * batch]):
            corner, plan = ds._draw(True)
            plain(ds.pairs[j], ds.flows[j], corner, (ch, cw), plan, x[s], y[s])
        yield {"x": x, "y": y}, (time.perf_counter() - t0) * 1e3


def fused_batches(ds: FlowDataset, batch: int, n: int, epoch_seed: int):
    it = ds.batches(batch, train=True, epoch_seed=epoch_seed)
    for _ in range(n):
        t0 = time.perf_counter()
        b = next(it)
        yield b, (time.perf_counter() - t0) * 1e3


def summary(ms):
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--hw", type=int, nargs=2, default=[384, 512])
    ap.add_argument("--crop", type=int, nargs=2, default=[256, 448])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.batch * args.batches > args.samples:
        ap.error("--batch x --batches must not exceed the training split of --samples")
    rng = np.random.default_rng(args.seed)
    h, w = args.hw
    pairs = rng.integers(0, 256, (args.samples, 2, h, w, 3), dtype=np.uint8)
    flows = rng.normal(0, 4, (args.samples, h, w, 2)).astype(np.float32)

    def dataset():
        return FlowDataset(pairs, flows, val_split=0.0, split_sizes=(args.samples, 0),
                           crop_hw=tuple(args.crop), aug=AugmentOptions(), seed=args.seed + 1)

    native.available()  # build the library outside the timing
    fused = list(fused_batches(dataset(), args.batch, args.batches, args.seed + 2))
    plain = list(plain_batches(dataset(), args.batch, args.batches, args.seed + 2))
    for k, ((a, _), (b, _)) in enumerate(zip(fused, plain)):
        if not (np.array_equal(a["x"], b["x"]) and np.array_equal(a["y"], b["y"])):
            raise AssertionError(f"batch {k}: the fused pass differs from its plain version")
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    out = {"cpu": platform.processor() or platform.machine(), "host_cores": cores,
           "shape": {"hw": args.hw, "crop": args.crop, "batch": args.batch},
           "batches": args.batches, "equal": True,
           "fused_ms": summary([t for _, t in fused]),
           "plain_ms": summary([t for _, t in plain])}
    print(f"fused {out['fused_ms']['median']:.2f} ms a batch, plain "
          f"{out['plain_ms']['median']:.2f} ms, {cores} cores, batches bit-equal")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
