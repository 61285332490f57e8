"""What `BENCHMARK.json` names, found by name: a cell (`workloads` entry),
its configuration file, its traffic mix (`workloads/<traffic>.json`, which
names its driver under `traffic/`) and the reader of each per-layer metric
(`metrics/<metric>.py`). Adding a configuration, a mix or a metric is adding
files and entries: nothing here lists them."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Manifest:
    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {[w['name'] for w in self.spec['workloads']]})")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> dict:
        path = self.bench_dir / "workloads" / f"{traffic}.json"
        if not path.exists():
            raise KeyError(f"no traffic mix {traffic!r} ({path})")
        with open(path) as f:
            return json.load(f)

    @staticmethod
    def driver(mix: dict):
        """The traffic driver module a mix names (`"driver": "video"` ->
        fisrbench.traffic.video)."""
        return importlib.import_module(f"fisrbench.traffic.{mix['driver']}")

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        """Per-layer metrics of `cell`: those listing it, and those without a
        list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, metric: str):
        """The `read(reading)` function of metrics/<metric>.py."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"fisrbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
