"""Tiny CPU contexts of the benchmark's cells for the tests: the cell's own
configuration and mix, cut by its driver's `tiny` to shapes a test run
holds."""

from __future__ import annotations

import copy
import time

import torch

from fisrbench.harness.manifest import Manifest
from fisrbench.harness.runner import RunContext


def tiny_ctx(cell_name: str, seed: int = 2**31 + 7, seconds: float = 0.5) -> RunContext:
    m = Manifest()
    cell = m.cell(cell_name)
    mix = m.mix(cell["traffic"])
    cfg, mix = m.driver(mix).tiny(copy.deepcopy(m.config(cell["config"])), copy.deepcopy(mix))
    return RunContext(cell=cell, config=cfg, mix=mix, seed=seed, seconds=seconds, trace=False,
                      device=torch.device("cpu"), t_start=time.perf_counter())


def cells_of(driver: str):
    m = Manifest()
    return [w["name"] for w in m.spec["workloads"] if m.mix(w["traffic"])["driver"] == driver]


def cells():
    return [w["name"] for w in Manifest().spec["workloads"]]
