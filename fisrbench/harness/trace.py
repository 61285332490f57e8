"""The device trace of a traced run, reduced in memory: `torch.profiler` over
the traced part of the window, read from its raw Kineto events (device
kernels, copies and sets; the host's torch operations), with no trace file
written.

From it: the device's busy time (the union of device intervals), its idle
gaps labelled by what the host was doing (the benchmark's own span and the
outermost torch operation running at the gap's middle), and device time by
kernel family.
"""

from __future__ import annotations

import bisect
import sys
import time
from contextlib import contextmanager

import torch

# (family, substrings of the kernel name), first match wins; the groups of
# the repository's video profile script, with the cost-volume kernels apart
FAMILIES = (
    ("cost_volume_fwd", ("cost_volume_kernel",)),
    ("cost_volume_bwd", ("cost_volume_bwd",)),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "gemm", "winograd", "fft", "sm90", "dgrad",
              "wgrad", "nhwc", "cutlass")),
    ("gather_index", ("index", "gather", "scatter")),
    ("memcpy_memset", ("memcpy", "memset")),
    ("copy_cat_pad", ("cat", "copy", "pad", "transpose", "permute")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "clamp", "leaky", "relu", "max_pool")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


class Spans:
    """Host spans of the benchmark's own calls into the program: (name,
    start_ns, end_ns) on the wall clock that Kineto's timestamps use."""

    def __init__(self):
        self.items = []

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def at(self, t_ns: int):
        """The innermost span that holds t_ns, or None."""
        best = None
        for name, a, b in self.items:
            if a <= t_ns <= b and (best is None or a >= best[1]):
                best = (name, a, b)
        return best[0] if best else None


class DeviceTrace:
    """`with DeviceTrace() as tr: ...` profiles the block (CPU and CUDA
    activity), synchronising the device at both ends; `tr.t0_ns`, `tr.t1_ns`
    are its wall-clock ends. The traced work runs on the calling thread."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def reduce(self, spans: Spans | None = None, top: int = 10) -> dict:
        """{'window_s', 'busy_s', 'kernels': [(name, start_ns, dur_ns)],
        'by_family': {family: s}, 'gaps': [(label, s)] (longest first)}."""
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((e.name(), start, dur))
            elif dur > 0:
                host.append((e.name(), start, start + dur))
        lo, hi = self.t0_ns, self.t1_ns
        n_all = len(dev)
        span_all = (min(s for _n, s, _d in dev) - lo, max(s + d for _n, s, d in dev) - hi) \
            if dev else None
        dev = [(n, max(s, lo), min(s + d, hi) - max(s, lo)) for n, s, d in dev
               if s + d > lo and s < hi]
        dev.sort(key=lambda k: k[1])
        busy, gaps, cur_end = 0, [], lo
        for _n, s, d in dev:
            if s > cur_end:
                gaps.append((cur_end, s))
            if s + d > cur_end:
                busy += s + d - max(s, cur_end)
                cur_end = s + d
        if hi > cur_end:
            gaps.append((cur_end, hi))
        by_family = {}
        for n, _s, d in dev:
            f = family(n)
            by_family[f] = by_family.get(f, 0.0) + d * 1e-9
        host.sort(key=lambda k: k[1])
        tops = []  # the outermost host operations, in order
        for h in host:
            if not tops or h[1] >= tops[-1][2]:
                tops.append(h)
        starts = [t[1] for t in tops]
        labelled = {}
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            outer = tops[i] if i >= 0 and tops[i][2] >= mid else None
            span = spans.at(mid) if spans else None
            label = f"{span or 'no span'} / {outer[0] if outer else 'no torch op'}"
            labelled[label] = labelled.get(label, 0.0) + (b - a) * 1e-9
        return {
            "window_s": (hi - lo) * 1e-9,
            "busy_s": busy * 1e-9,
            "kernels": dev,
            "by_family": by_family,
            "gaps": sorted(labelled.items(), key=lambda kv: -kv[1])[:top],
            "idle_gap_count": len(gaps),
            "device_events": (n_all, len(dev), span_all),
        }


def traced(body, spans: Spans, expect: dict, tries: int = 3) -> dict:
    """Run `body()` under a DeviceTrace and reduce it, again while the trace
    lacks launches that the work is known to make (`expect`: {kernel name
    substring: count}; the profiler can lose device events); fails after
    `tries` traces that lost events."""
    for attempt in range(tries):
        with DeviceTrace() as tr:
            body()
        red = tr.reduce(spans)
        counts = {k: sum(1 for name, _s, _d in red["kernels"] if k in name) for k in expect}
        if counts == expect:
            return red
        print(f"trace {attempt + 1} of {tries} lost device events: launches {counts}, "
              f"expected {expect}", file=sys.stderr)
    raise RuntimeError(f"the device trace lost events in {tries} traces; no result")
