"""Tracing and profiling hooks (port of fisr_tpu/utils/profiling.py).

* `trace(name)`           - wall-clock scope timer that synchronises the
                            device work it was given before reading the clock;
* `device_trace(logdir)`  - a torch.profiler trace of the scope into `logdir`
                            (Chrome trace JSON, viewable in TensorBoard);
* `StepTimer`             - steps/s and an EMA for training loops;
* `device_memory_stats()` - memory in use, peak and total per CUDA device;
* `assert_fits_hbm`       - a pre-flight memory check that raises an
                            actionable error instead of an allocator failure
                            on the first real request.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

from fisr_tpu_torch.device import resolve_device

__all__ = ["trace", "device_trace", "StepTimer", "device_memory_stats", "sync",
           "assert_fits_hbm", "check_memory_budget"]


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
def trace(name: str, result_holder: Optional[dict] = None, sync_on=None,
          verbose: bool = True):
    t0 = time.perf_counter()
    yield
    sync(sync_on)
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder[name] = dt
    if verbose:
        print(f"[trace] {name}: {dt * 1e3:.2f} ms", flush=True)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace (host, and the card where there is one)
    into `logdir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    """Throughput bookkeeping for training loops."""

    def __init__(self, batch_size: int, ema: float = 0.95):
        self.batch_size = batch_size
        self.ema = ema
        self._avg = None
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._avg = dt if self._avg is None else (
                self.ema * self._avg + (1 - self.ema) * dt)
        self._last = now

    @property
    def sec_per_step(self) -> float:
        return self._avg or float("nan")

    @property
    def samples_per_sec(self) -> float:
        return self.batch_size / self._avg if self._avg else float("nan")

    def eta_str(self, steps_left: int) -> str:
        if not self._avg:
            return "?"
        s = int(steps_left * self._avg)
        return f"{s // 3600:02d}:{s % 3600 // 60:02d}:{s % 60:02d}"


def device_memory_stats() -> Dict[str, dict]:
    """{"cuda:<i>": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}} for
    every CUDA device; empty without one."""
    out = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"cuda:{i}"] = {
                "bytes_in_use": torch.cuda.memory_allocated(i),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                "bytes_limit": torch.cuda.mem_get_info(i)[1],
            }
    return out
