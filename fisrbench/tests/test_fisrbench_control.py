"""Each cell's control (the reference one precision below the configuration,
in the program's place, judged by the driver's own check) fails the cell: on
the card at the cell's own size under the cell's limits, and on the CPU at a
tiny size far above a sound run's reading. On the card:
python3 -m pytest fisrbench/tests/test_fisrbench_control.py -m cuda."""

from __future__ import annotations

import time

import pytest
import torch

from fisrbench.harness.controls import lower
from fisrbench.harness.manifest import Manifest
from fisrbench.harness.runner import RunContext, judged
from fisrbench.tests.tiny import cells, tiny_ctx

SEEDS = (3100000001, 3100000002, 3100000003)


def _numerics(cell: str) -> str:
    m = Manifest()
    return lower(m.config(m.cell(cell)["config"]))


@pytest.mark.parametrize("cell", cells())
def test_control_reads_far_above_a_sound_run_on_the_cpu(cell):
    ctx = tiny_ctx(cell)
    driver = Manifest.driver(ctx.mix)
    control, failed = driver.control(ctx, _numerics(cell))
    assert failed == 0
    sound = {n: v for n, v, _ in driver.run(tiny_ctx(cell, seconds=1.0)).checks}
    assert any(v > 10 * sound[n] for n, v, _ in control), (control, sound)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_control_fails_the_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    m = Manifest()
    spec = m.cell(cell)
    mix, config = m.mix(spec["traffic"]), m.config(spec["config"])
    for seed in SEEDS:
        ctx = RunContext(cell=spec, config=config, mix=mix, seed=seed, seconds=0.0,
                         trace=False, device=torch.device("cuda", 0),
                         t_start=time.perf_counter())
        checks, failed = m.driver(mix).control(ctx, lower(config))
        assert not judged(checks, failed), (seed, checks)


@pytest.mark.parametrize("config, numerics", [
    ({"compute_dtype": "bfloat16"}, "fp8"), ({"compute_dtype": "float32"}, "tf32"),
    ({"compute_dtype": "float32", "tf32": False}, "tf32")])
def test_control_is_one_precision_below_the_configuration(config, numerics):
    assert lower(config) == numerics


@pytest.mark.parametrize("config", [{"compute_dtype": "float32", "tf32": True},
                                    {"compute_dtype": "float16"}])
def test_a_configuration_without_a_control_is_refused(config):
    with pytest.raises(ValueError):
        lower(config)
