"""The benchmark of the PyTorch and CUDA port (fisr_tpu_torch) on one H100.

    python3 -m fisrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in BENCHMARK.json, its configuration file, its traffic mix
(fisrbench/workloads/<traffic>.json) and the mix's driver
(fisrbench/traffic/<driver>.py), which sets the program up from the seed,
measures for `--seconds` and checks what the timed path produced against the
plain reference (fisrbench/reference/). With --trace 0 the last line of
standard output holds the cell's end-to-end metrics; with --trace 1 its
per-layer metrics, each read by fisrbench/metrics/<metric>.py from the
device trace, the counts and the clocks. The numbers compared, each beside
its limit, are the last lines of standard error and the last key of the
result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up runs from here to the window's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fisr_tpu")
ROOT = Path(__file__).resolve().parents[1]


def _pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own builds go to build/fisr_tpu_torch/ there already)."""
    cache = ROOT / "build" / "fisrbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    os.environ["USE_FLAX"] = "0"


def _forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    sys.path.insert(0, str(ROOT))

    from fisrbench.harness.manifest import Manifest
    from fisrbench.harness.runner import RunContext

    manifest = Manifest()
    cell = manifest.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"fisrbench: cell {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2

    mix = manifest.mix(cell["traffic"])
    ctx = RunContext(cell=cell, config=manifest.config(cell["config"]), mix=mix,
                     seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device=torch.device("cuda", 0), t_start=T_START)
    outcome = manifest.driver(mix).run(ctx)

    found = _forbidden_modules()
    if found:
        print(f"fisrbench: the process loaded {found} (the JAX side); no result",
              file=sys.stderr)
        return 3

    if args.trace:
        metrics = {}
        for m in manifest.per_layer(cell["name"]):
            value = manifest.reader(m["name"])(outcome.reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(outcome.e2e, setup_s=outcome.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(cell["name"])}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device}
    if args.trace:
        tr = outcome.reading["trace"]
        n_all, n_in, span = tr["device_events"]
        print(f"trace: {n_all} device events, {n_in} inside the traced {tr['window_s']:.3f} s; "
              f"first start and last end against its ends (ns): {span}", file=sys.stderr)
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {
            "device_ops": sorted(([f, s] for f, s in tr["by_family"].items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[label, s] for label, s in tr["gaps"]][:10]}
    result["checked"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    for name, v, lim in outcome.checks:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"check correct = {outcome.correct}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
