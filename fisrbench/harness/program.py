"""The program's own stage spans and counters: `totals()` of
`fisr_tpu_torch.utils.profiling`, read in the process that ran the cell,
after the cell's traffic ran. They cover the whole run: the set-up's
warm-up, the measured window and a traced part. In a traced train run the
traced steps fill the window, so its batches are the set-up's and the
traced steps'.

A reader returns None where the program has no recorder (no `totals`, as
before the recorder was added), where a span it divides was never recorded,
or where its denominator reads 0. Each metric file under fisrbench/metrics/
that reads a span binds one of these."""

from __future__ import annotations


def totals():
    """The program's {"spans": {name: (calls, s)}, "counters": {name: n}},
    or None."""
    try:
        from fisr_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "totals", None)
    return read() if callable(read) else None


def _seconds(t: dict, spans) -> float | None:
    found = [t["spans"][s][1] for s in spans if s in t["spans"]]
    return sum(found) if found else None


def ms_per(spans: tuple, counter: str):
    """Reader: the summed seconds of `spans`, in ms, over the counter."""
    def read(_reading):
        t = totals()
        if t is None or not t["counters"].get(counter):
            return None
        s = _seconds(t, spans)
        return None if s is None else 1e3 * s / t["counters"][counter]
    return read


def pct_of(part: str, whole: str):
    """Reader: the seconds of span `part` as a share of span `whole`'s."""
    def read(_reading):
        t = totals()
        if t is None:
            return None
        p, w = _seconds(t, (part,)), _seconds(t, (whole,))
        return None if p is None or not w else 100.0 * p / w
    return read
