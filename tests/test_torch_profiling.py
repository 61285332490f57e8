"""Port: utils/profiling.py against fisr_tpu.utils.profiling.

`trace` and `StepTimer` as the JAX tests hold them. The memory check differs
by design: the JAX package reads a compile-time estimate, the port measures
the call's peak on the card (torch.cuda.max_memory_allocated less what was
allocated before it). On the CPU the comparison and its message are held
through `check_memory_budget`, and the measuring path through stand-ins for
the torch.cuda memory counters; the card case is in test_torch_autotune.py.
"""

import glob
import os
import time

import pytest
import torch

from fisr_tpu.utils import profiling as jprofiling
from fisr_tpu_torch.utils import profiling
from fisr_tpu_torch.utils.profiling import (StepTimer, assert_fits_hbm, check_memory_budget,
                                            device_memory_stats, sync, trace)

torch.set_num_threads(1)
GIB = 1024 ** 3


def test_trace_and_steptimer(capsys, monkeypatch):
    holder = {}
    with trace("unit", holder, verbose=False, sync_on=torch.ones(3)):
        sum(range(1000))
    assert holder["unit"] >= 0
    with trace("loud"):
        pass
    assert "[trace] loud:" in capsys.readouterr().out

    st = StepTimer(batch_size=8)
    assert st.eta_str(10) == "?" and st.sec_per_step != st.sec_per_step  # nan
    st.tick()
    st.tick()
    assert st.sec_per_step >= 0
    assert st.samples_per_sec > 0
    assert ":" in st.eta_str(100)
    # the same EMA as the JAX timer over the same intervals (1 s, then 3 s)
    clock = iter([0.0, 1.0, 4.0, 0.0, 1.0, 4.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    ours, theirs = StepTimer(4, ema=0.5), jprofiling.StepTimer(4, ema=0.5)
    for t in (ours, theirs):
        for _ in range(3):
            t.tick()
    monkeypatch.undo()
    assert ours.sec_per_step == theirs.sec_per_step == 2.0
    assert ours.samples_per_sec == theirs.samples_per_sec == 2.0
    assert ours.eta_str(3600) == theirs.eta_str(3600) == "02:00:00"

    assert device_memory_stats() == {}  # no card here
    sync()
    sync({"x": [torch.zeros(2)]})


def test_memory_budget_check_raises_an_actionable_error():
    info = check_memory_budget(GIB, 4 * GIB, what="window")
    assert info == {"what": "window", "need_bytes": GIB, "limit_bytes": 4 * GIB,
                    "budget_bytes": int(4 * GIB * 0.94)}
    # the budget is margin x limit, not the limit
    with pytest.raises(RuntimeError) as e:
        check_memory_budget(int(3.9 * GIB), 4 * GIB, what="fused 2048x3840 window")
    msg = str(e.value)
    for part in ("fused 2048x3840 window", "~3.90 GiB", "HBM", "3.76 GiB", "94%", "4.00 GiB",
                 "geometry", "--fisr_grid GH,GW", "python -m fisr_tpu_torch.cli.tune",
                 "--fisr_grid tuned"):
        assert part in msg, (part, msg)
    assert check_memory_budget(int(3.9 * GIB), 4 * GIB, margin=1.0)["budget_bytes"] == 4 * GIB


def test_assert_fits_hbm_on_the_cpu_runs_and_measures_nothing():
    calls = []
    x = torch.ones(4)
    assert assert_fits_hbm(lambda t: calls.append(t.sum()), (x,), what="cpu") is None
    assert len(calls) == 1
    assert assert_fits_hbm(lambda: calls.append(1), device="cpu") is None
    assert len(calls) == 2


def test_assert_fits_hbm_needs_a_card_when_it_names_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        assert_fits_hbm(lambda: None)


class _FakeCard:
    """Stand-ins for the torch.cuda memory counters of one 80 GiB card."""

    def __init__(self, monkeypatch, before, peak):
        self.peak, self.resets = peak, 0
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
        monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (0, 80 * GIB))
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: before)
        monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: self.peak)
        monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", self.reset)

    def reset(self, d):
        self.resets += 1


def test_assert_fits_hbm_measures_the_peak_above_what_was_there(monkeypatch):
    card = _FakeCard(monkeypatch, before=10 * GIB, peak=30 * GIB)
    info = assert_fits_hbm(lambda: None, what="window", device="cuda")
    assert card.resets == 1
    assert info == {"what": "window", "need_bytes": 20 * GIB, "limit_bytes": 80 * GIB,
                    "budget_bytes": int(80 * GIB * 0.94)}
    with pytest.raises(RuntimeError, match="~20.00 GiB"):
        assert_fits_hbm(lambda: None, what="window", device="cuda", limit_bytes=16 * GIB)


def test_assert_fits_hbm_turns_running_out_into_the_same_error(monkeypatch):
    _FakeCard(monkeypatch, before=0, peak=0)

    def oom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(RuntimeError, match="--fisr_grid GH,GW") as e:
        assert_fits_hbm(oom, what="window", device="cuda")
    assert isinstance(e.value.__cause__, torch.cuda.OutOfMemoryError)
    # any other error propagates as it is
    with pytest.raises(ZeroDivisionError):
        assert_fits_hbm(lambda: 1 / 0, what="window", device="cuda")


def test_device_trace_writes_a_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.device_trace(logdir):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    assert glob.glob(os.path.join(logdir, "*.json"))
