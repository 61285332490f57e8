"""The arithmetic behind the per-layer metrics, over what a traced run
collected (`Outcome.reading`):

* trace: harness/trace.DeviceTrace.reduce() of the traced part of the window;
* units: {unit: count} of work done in that part (frames, windows, pairs,
  steps);
* cpu_s, cpu_units: the process's CPU seconds (os.times, all threads) over
  the untraced rest of the window and the units done there, or None;
* flops: {unit: useful FLOPs of one unit} (harness/work.py), peak_flops;
* cv_fwd, cv_bwd: {kernel, launches_per_cycle, bound_s_per_cycle}, the
  cost volume's launches a unit and their least time from the shapes;
* load: {units, seconds}, the work done in the measured window and its
  length, where the trace was taken outside it (serving);
* latency_ms: every request's round trip in the window.

Each function returns None where the run has nothing to read. Each metric
file under fisrbench/metrics/ binds one of them."""

from __future__ import annotations

import numpy as np

from fisrbench.harness.trace import family


def host_cpu_ms_per(unit: str):
    def read(r):
        if not r.get("cpu_s") or not r.get("cpu_units") or not r["cpu_units"].get(unit):
            return None
        return 1e3 * r["cpu_s"] / r["cpu_units"][unit]
    return read


def device_busy_ms_per(unit: str):
    def read(r):
        n = r.get("units", {}).get(unit)
        return 1e3 * r["trace"]["busy_s"] / n if n else None
    return read


def device_idle_pct(r):
    tr = r["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr["window_s"] > 0 else None


def kernels_per(unit: str):
    def read(r):
        n = r.get("units", {}).get(unit)
        if not n:
            return None
        k = sum(1 for name, _s, _d in r["trace"]["kernels"] if family(name) != "memcpy_memset")
        return k / n
    return read


def roofline_pct(key: str):
    """Least time of the cost volume's launches in the trace over their
    summed device time."""
    def read(r):
        cv = r.get(key)
        if not cv:
            return None
        durs = [d for name, _s, d in r["trace"]["kernels"] if cv["kernel"] in name]
        if not durs or sum(durs) <= 0:
            return None
        cycles = len(durs) / cv["launches_per_cycle"]
        return 100.0 * cycles * cv["bound_s_per_cycle"] / (sum(durs) * 1e-9)
    return read


def mfu_pct(r):
    """Useful FLOPs of the traced work over the traced window at the peak."""
    flops = sum(r["units"][u] * f for u, f in r.get("flops", {}).items())
    tr = r["trace"]
    if not flops or tr["window_s"] <= 0:
        return None
    return 100.0 * flops / (tr["window_s"] * r["peak_flops"])


def mfu_under_load_pct(r):
    """Useful FLOPs of the work done in the measured window over its length
    at the peak."""
    load = r.get("load")
    if not load or load["seconds"] <= 0:
        return None
    flops = sum(load["units"][u] * f for u, f in r.get("flops", {}).items())
    return 100.0 * flops / (load["seconds"] * r["peak_flops"]) if flops else None


def device_load_pct(unit: str):
    """The device's busy share under the measured window's load: the traced
    busy time a unit times the units done in the window, over its length."""
    def read(r):
        load, n = r.get("load"), r.get("units", {}).get(unit)
        if not load or not n or load["seconds"] <= 0:
            return None
        return 100.0 * r["trace"]["busy_s"] / n * load["units"][unit] / load["seconds"]
    return read


def latency_pct(q: float):
    """The q-th percentile of the requests' round trips (numpy's linear
    interpolation)."""
    def read(r):
        lat = r.get("latency_ms")
        if not lat:
            return None
        return float(np.percentile(lat, q))
    return read
