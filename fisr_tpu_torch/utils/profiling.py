"""Tracing and profiling hooks (port of fisr_tpu/utils/profiling.py).

* `span(name)`            - a stage span: its wall time and one call go into
                            a process-wide total under `name`; while a torch
                            profiler collects it is also a
                            `torch.profiler.record_function`, so it shows on
                            the device trace's own clock;
* `count(name, n=1)`      - a process-wide counter;
* `totals()`              - a copy of the spans' and counters' totals;
* `device_trace(logdir)`  - a torch.profiler trace of the scope, every
                            thread's host events included, into `logdir`
                            (Chrome trace JSON, viewable in TensorBoard);
* `assert_fits_hbm`       - a pre-flight memory check that raises an
                            actionable error instead of an allocator failure
                            on the first real request.

The recorder is exact under threads: writer, handler and pool threads all
record into it, each into totals of its own that `totals()` sums, and a
thread's totals are folded into those of ended threads when it ends. While
no profiler collects, a span costs a flag read, two clock reads and an add
without a lock, and never calls into the profiler.

A design rule: a span on a thread that dispatches device work does not
enclose torch operations. The benchmark labels a device idle gap with the
outermost host operation at its middle, so a span around dispatch would
replace the `aten::` labels under it with a coarser one. Spans mark host
stages (PNG decode and encode, colour, batch assembly, lock waits, socket
reads and writes) and the waits between them.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from time import perf_counter_ns
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from fisr_tpu_torch.device import resolve_device

__all__ = ["span", "count", "totals", "device_trace", "sync", "assert_fits_hbm",
           "check_memory_budget"]

# Each thread writes only its own {name: (calls, ns)} and {name: n}, replacing
# a tuple whole, so a reader on another thread sees no half-made update.
# `_lock` guards `_live` (each live thread's pair) and `_ended`.
_lock = threading.Lock()
_live = {}
_ended = ({}, {})
_here = threading.local()
_keys = itertools.count()


def _add(spans: dict, counters: dict, into: tuple) -> None:
    for k, (c, ns) in spans.items():
        c0, ns0 = into[0].get(k, (0, 0))
        into[0][k] = (c0 + c, ns0 + ns)
    for k, n in counters.items():
        into[1][k] = into[1].get(k, 0) + n


class _Owner:
    """Held in one thread's local storage alone: when the thread ends and its
    storage is dropped, the thread's totals fold into `_ended`."""

    __slots__ = ("key",)

    def __init__(self, key: int):
        self.key = key

    # bound here: at interpreter exit the module's globals may be gone first
    def __del__(self, lock=_lock, live=_live, ended=_ended, add=_add):
        with lock:
            add(*live.pop(self.key), ended)


def _enrol() -> tuple:
    """This thread's (spans, counters), made on its first record."""
    mine = ({}, {})
    key = next(_keys)
    with _lock:
        _live[key] = mine
    _here.owner = _Owner(key)
    _here.spans, _here.counters = mine
    return mine


class span:
    """`with span("video.encode"): ...` adds the block's wall time and one
    call to the total under the name; see the module docstring."""

    __slots__ = ("name", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # torch's own flag for fast checks: set while a profiler collects;
        # reading it calls nothing in the profiler
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, typ, value, tb):
        dt = perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(typ, value, tb)
        try:
            mine = _here.spans
        except AttributeError:
            mine = _enrol()[0]
        c = mine.get(self.name)
        mine[self.name] = (1, dt) if c is None else (c[0] + 1, c[1] + dt)
        return False


def count(name: str, n: int = 1) -> None:
    """Add `n` to the process-wide counter `name`."""
    try:
        mine = _here.counters
    except AttributeError:
        mine = _enrol()[1]
    mine[name] = mine.get(name, 0) + n


def totals() -> dict:
    """{"spans": {name: (calls, seconds)}, "counters": {name: n}}: a copy of
    what every thread has recorded."""
    out = ({}, {})
    with _lock:
        # dict() of a dict copies it in one step, so a thread adding a name
        # meanwhile cannot break the copy
        for spans, counters in [_ended, *_live.values()]:
            _add(dict(spans), dict(counters), out)
    return {"spans": {k: (c, ns * 1e-9) for k, (c, ns) in out[0].items()},
            "counters": out[1]}


def _over_budget(what: str, need: str, budget: int, limit: int, margin: float) -> RuntimeError:
    gib = 1024 ** 3
    return RuntimeError(
        f"{what} needs {need} of device memory (HBM) but the budget is {budget / gib:.2f} GiB "
        f"({margin:.0%} of {limit / gib:.2f} GiB). Options: reduce the frame geometry; use a "
        f"finer tiling plan (--fisr_grid GH,GW, or run `python -m fisr_tpu_torch.cli.tune` and "
        f"pass --fisr_grid tuned).")


def check_memory_budget(need: int, limit: int, what: str = "program",
                        margin: float = 0.94) -> dict:
    """{"what", "need_bytes", "limit_bytes", "budget_bytes"}; raises an
    actionable RuntimeError when `need` exceeds `margin` of `limit`."""
    budget = int(limit * margin)
    if need > budget:
        raise _over_budget(what, f"~{need / 1024 ** 3:.2f} GiB", budget, limit, margin)
    return {"what": what, "need_bytes": int(need), "limit_bytes": int(limit),
            "budget_bytes": budget}


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, (list, tuple)):
        for t in tree:
            found = _first_tensor(t)
            if found is not None:
                return found
    if isinstance(tree, dict):
        return _first_tensor(list(tree.values()))
    return None


def assert_fits_hbm(fn, args=(), what: str = "program", limit_bytes: Optional[int] = None,
                    margin: float = 0.94, device=None) -> Optional[dict]:
    """Run `fn(*args)` once and raise an actionable RuntimeError if its peak
    device memory exceeds `margin` of the card's.

    The JAX package reads a compile-time estimate (the compiled program's
    memory analysis); PyTorch has none, so this measures: the peak allocated
    during the call, less what was allocated before it. The limit is
    `limit_bytes`, else the card's total memory (`torch.cuda.mem_get_info`).
    A `torch.cuda.OutOfMemoryError` inside the call is raised as the same
    RuntimeError. `device` defaults to that of the first tensor in `args`,
    else "cuda". Returns {"need_bytes", "limit_bytes", "budget_bytes",
    "what"}; on the CPU the call runs and the result is None (no measure).
    """
    t = _first_tensor(args)
    dev = resolve_device(device if device is not None else (t.device if t is not None else "cuda"))
    if dev.type != "cuda":
        fn(*args)
        return None
    limit = limit_bytes or torch.cuda.mem_get_info(dev)[1]
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        fn(*args)
        torch.cuda.synchronize(dev)
    except torch.cuda.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        raise _over_budget(what, "more than the card has (it ran out)", int(limit * margin),
                           limit, margin) from e
    return check_memory_budget(torch.cuda.max_memory_allocated(dev) - before, limit, what,
                               margin)


def sync(x=None) -> None:
    """Fence: wait for the device work behind `x` (a tensor or a nest of
    them), or for every CUDA device when `x` is None."""
    t = _first_tensor(x)
    if t is not None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace (host, and the card where there is one)
    into `logdir`. Every thread's host events are recorded (the profiler's
    experimental `profile_all_threads`), so the stage spans of writer and
    handler threads show beside the kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)):
        yield
