"""Port: utils/profiling.py against fisr_tpu.utils.profiling, and the
port's stage-span recorder.

The memory check differs by design: the JAX package reads a compile-time
estimate, the port measures the call's peak on the card
(torch.cuda.max_memory_allocated less what was allocated before it). On the
CPU the comparison and its message are held through `check_memory_budget`,
and the measuring path through stand-ins for the torch.cuda memory counters;
the card case is in test_torch_autotune.py.

The recorder (`span`, `count`, `totals`) has no JAX counterpart: its totals
are held exact over threads, its spans against the profiler's own host
events and the wall clock the benchmark labels idle gaps by, and its cost
while no profiler runs against a bound of 2 us a span.
"""

import glob
import json
import os
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fisr_tpu_torch.utils import profiling
from fisr_tpu_torch.utils.profiling import assert_fits_hbm, check_memory_budget, span, sync

torch.set_num_threads(1)
GIB = 1024 ** 3


def _calls(t, name):
    return t["spans"].get(name, (0, 0.0))[0]


def test_sync_fences_a_tensor_a_nest_and_every_device():
    sync()
    sync(torch.ones(3))
    sync({"x": [torch.zeros(2)]})
    sync([])  # nothing to wait for


def test_spans_and_counters_are_exact_over_threads(monkeypatch):
    def no_profiler(*a, **k):
        raise AssertionError("the recorder called into the profiler with none running")

    monkeypatch.setattr(torch.profiler, "record_function", no_profiler)
    before = profiling.totals()
    start = threading.Barrier(8)
    keys = []  # each thread's entry in the recorder

    def work():
        start.wait()
        profiling.count("test.threads.n", 0)
        keys.append(profiling._here.owner.key)
        for _ in range(1000):
            with span("test.threads"):
                pass
            profiling.count("test.threads.n", 2)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass  # a profiler that ran and stopped leaves the recorder off
    threads = [threading.Thread(target=work) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often, so a lost update would show
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    after = profiling.totals()
    assert _calls(after, "test.threads") - _calls(before, "test.threads") == 8000
    assert (after["counters"]["test.threads.n"]
            - before["counters"].get("test.threads.n", 0)) == 16000
    calls, seconds = after["spans"]["test.threads"]
    assert seconds > 0 and isinstance(calls, int)
    # the ended threads' totals were folded in: none of them is still held
    assert not any(k in profiling._live for k in keys)
    assert not any(e.name().startswith("test.") for e in prof.profiler.kineto_results.events())
    # totals() is a copy
    after["spans"]["test.threads"] = (0, 0.0)
    after["counters"]["test.threads.n"] = 0
    assert profiling.totals()["counters"]["test.threads.n"] >= 16000


def test_a_span_under_the_profiler_is_one_host_event_on_the_wall_clock():
    before = profiling.totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        with span("test.traced"):
            torch.ones(8, 8).sum()
        t1 = time.time_ns()
        profiling.count("test.traced.n")
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    mine = [e for e in events if e[0] == "test.traced"]
    assert len(mine) == 1
    _, a, b = mine[0]
    assert t0 <= a <= t1 and a < b
    inner = [e for e in events if e[0].startswith("aten::")]
    assert inner and all(a <= s and z <= b for _n, s, z in inner)
    # a traced span and count go into the same totals as untraced ones
    t = profiling.totals()
    assert _calls(t, "test.traced") - _calls(before, "test.traced") == 1
    assert t["counters"]["test.traced.n"] - before["counters"].get("test.traced.n", 0) == 1


def test_the_off_path_costs_at_most_2_us_a_span(record_property):
    n, best = 100_000, float("inf")
    for _ in range(10):  # the best of ten rounds: the host is shared
        t0 = time.perf_counter()
        for _ in range(n):
            with span("test.cost"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    record_property("ns_a_span", round(best * 1e9))
    print(f"span off the profiler: {best * 1e9:.0f} ns a span, best of 10 x {n}")
    assert best <= 2e-6


def test_device_trace_writes_a_trace(tmp_path):
    """A trace file, with a pool thread's span in it beside the calling thread's
    operations."""
    def pool_thread():
        with span("test.pool_thread"):
            time.sleep(0.001)

    logdir = str(tmp_path / "trace")
    with profiling.device_trace(logdir):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
        t = threading.Thread(target=pool_thread)
        t.start()
        t.join()
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert files
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "test.pool_thread" in names
    assert any(n and n.startswith("aten::") for n in names)


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
