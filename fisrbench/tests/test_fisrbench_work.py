"""The yardstick's counters against hand counts at tiny shapes, and the
readers' arithmetic on a made-up reading."""

from __future__ import annotations

import pytest
import torch

from fisrbench.harness import readers, work
from fisrbench.harness.trace import family
from fisrbench.reference.ops import Numerics


def test_conv_macs_by_hand():
    nx = Numerics()
    nx.conv(torch.zeros(2, 8, 8, 16), torch.zeros(4, 16, 3, 3), torch.zeros(4))
    assert nx.macs == 2 * 8 * 8 * 4 * 16 * 9
    nx = Numerics()
    nx.conv(torch.zeros(1, 8, 8, 16), torch.zeros(4, 16, 3, 3), torch.zeros(4), stride=2)
    assert nx.macs == 4 * 4 * 4 * 16 * 9
    nx = Numerics()
    nx.deconv(torch.zeros(1, 4, 4, 6), torch.zeros(6, 2, 4, 4), torch.zeros(2))
    assert nx.macs == 4 * 4 * 6 * 2 * 16
    nx = Numerics()
    nx.cost_volume(torch.zeros(1, 5, 6, 7), torch.zeros(1, 5, 6, 7), 4)
    assert nx.macs == 5 * 6 * 7 * 81


def test_meta_walk_equals_eager_count():
    cfg = dict(pyr_lvls=6, flow_pred_lvl=2, search_range=4)
    from fisrbench.reference.pwcnet import PWCNetRef, param_shapes
    nx = Numerics()
    p = {k: torch.zeros(s) for k, s in param_shapes(**cfg).items()}
    net = PWCNetRef(p, numerics=nx, **cfg)
    x = torch.zeros(1, 64, 128, 3)
    net(x, x)
    assert work.pwc_flops(1, 64, 128, cfg) == 2 * nx.macs
    # the pyramid's first conv alone: 3 -> 16 channels, stride 2, per image
    assert nx.macs > 2 * 32 * 64 * 16 * 3 * 9


def test_cv_bounds_by_hand():
    shape = (2, 4, 8, 32)
    px = 2 * 4 * 8
    fwd_bytes = (2 * px * 32 + px * 81) * 2
    fwd_ops = 2 * 81 * 32 * px
    assert work.cv_bound_s(shape, "bfloat16") == pytest.approx(
        max(fwd_bytes / 3.35e12, fwd_ops / 989e12))
    bwd_bytes = px * (81 + 4 * 32) * 4
    bwd_ops = 4 * 81 * 32 * px
    assert work.cv_bwd_bound_s(shape, "float32") == pytest.approx(
        max(bwd_bytes / 3.35e12, bwd_ops / 67e12))
    assert work.pwc_level_shapes(8, 256, 448, dict(pyr_lvls=6, flow_pred_lvl=2)) == [
        (8, 4, 7, 196), (8, 8, 14, 128), (8, 16, 28, 96), (8, 32, 56, 64), (8, 64, 112, 32)]


def test_readers_on_a_made_up_reading():
    k = [("cost_volume_kernel_fma_f32<4>", 0, 2_000_000), ("void cudnn::conv", 0, 6_000_000),
         ("Memcpy HtoD", 0, 1_000_000)] * 5
    r = {"trace": {"busy_s": 0.5, "window_s": 2.0, "kernels": k},
         "units": {"steps": 5}, "cpu_s": 1.5, "cpu_units": {"steps": 10},
         "flops": {"steps": 1e12}, "peak_flops": 67e12,
         "cv_fwd": {"kernel": "cost_volume_kernel", "launches_per_cycle": 1,
                    "bound_s_per_cycle": 1e-3}}
    assert readers.device_idle_pct(r) == 75.0
    assert readers.host_cpu_ms_per("steps")(r) == 150.0
    assert readers.device_busy_ms_per("steps")(r) == 100.0
    assert readers.kernels_per("steps")(r) == 2.0
    assert readers.mfu_pct(r) == pytest.approx(100 * 5e12 / (2.0 * 67e12))
    assert readers.roofline_pct("cv_fwd")(r) == pytest.approx(50.0)
    assert readers.roofline_pct("cv_bwd")(r) is None
    assert readers.host_cpu_ms_per("steps")(dict(r, cpu_s=None)) is None
    assert family("cost_volume_bwd_f32<2,4>") == "cost_volume_bwd"
