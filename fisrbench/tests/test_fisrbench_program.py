"""The readers of the program's stage spans (harness/program.py, and the
seven metric files that bind it): each gives the value worked out by hand
from a given `totals`, and None where the program has no `totals` (as
before the recorder) or a denominator reads 0."""

from __future__ import annotations

import sys
import types

import pytest

from fisrbench.harness.manifest import Manifest

TOTALS = {
    "spans": {"video.encode": (60, 3.0), "video.colour": (30, 1.5), "video.flush": (2, 0.6),
              "serve.lock_wait": (10, 2.5), "serve.unpack": (10, 1.2),
              "serve.pack": (10, 0.8), "data.batch": (40, 12.0), "data.augment": (320, 9.0)},
    "counters": {"video.frames": 30, "serve.windows": 10, "data.batches": 40},
}
WANT = {
    "encode_ms_per_frame.video": 100.0,       # 3.0 s / 30 frames
    "colour_ms_per_frame.video": 50.0,        # 1.5 s / 30
    "flush_ms_per_frame.video": 20.0,         # 0.6 s / 30
    "lock_wait_ms_per_window.serve": 250.0,   # 2.5 s / 10 windows
    "png_ms_per_window.serve": 200.0,         # (1.2 + 0.8) s / 10
    "batch_ms_per_step.train": 300.0,         # 12 s / 40 batches
    "augment_pct.train": 75.0,                # 9 / 12
}
ZEROED = {  # the denominator each reader divides by
    "encode_ms_per_frame.video": ("counters", "video.frames"),
    "colour_ms_per_frame.video": ("counters", "video.frames"),
    "flush_ms_per_frame.video": ("counters", "video.frames"),
    "lock_wait_ms_per_window.serve": ("counters", "serve.windows"),
    "png_ms_per_window.serve": ("counters", "serve.windows"),
    "batch_ms_per_step.train": ("counters", "data.batches"),
    "augment_pct.train": ("spans", "data.batch"),
}


def _program(monkeypatch, totals=None, **attrs):
    """A stand-in for fisr_tpu_torch.utils.profiling: with `totals` given,
    its totals() returns them."""
    mod = types.ModuleType("fisr_tpu_torch.utils.profiling")
    if totals is not None:
        mod.totals = lambda: totals
    for k, v in attrs.items():
        setattr(mod, k, v)
    pkg = types.ModuleType("fisr_tpu_torch.utils")
    pkg.profiling = mod
    monkeypatch.setitem(sys.modules, "fisr_tpu_torch.utils", pkg)
    monkeypatch.setitem(sys.modules, "fisr_tpu_torch.utils.profiling", mod)


def test_every_span_metric_is_in_the_manifest():
    m = Manifest()
    spans = {x["name"] for x in m.spec["per_layer"] if x["source"] == "program_span"}
    assert spans == set(WANT)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_gives_the_value_worked_out_by_hand(monkeypatch, metric):
    _program(monkeypatch, TOTALS)
    assert Manifest().reader(metric)({}) == pytest.approx(WANT[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_is_none_without_totals_or_with_a_zero_denominator(monkeypatch, metric):
    read = Manifest().reader(metric)
    _program(monkeypatch, None, sync=lambda x=None: None)  # a program with no recorder
    assert read({}) is None
    kind, name = ZEROED[metric]
    zeroed = {"spans": dict(TOTALS["spans"]), "counters": dict(TOTALS["counters"])}
    zeroed[kind][name] = (40, 0.0) if kind == "spans" else 0
    _program(monkeypatch, zeroed)
    assert read({}) is None
    _program(monkeypatch, {"spans": {}, "counters": {}})  # nothing recorded
    assert read({}) is None
