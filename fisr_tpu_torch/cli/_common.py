"""CLI argument grammar shared by the port's entry points."""

from __future__ import annotations

from typing import Tuple, Union

GridSpec = Union[None, str, Tuple[int, int]]

__all__ = ["GridSpec", "parse_grid"]


def parse_grid(s: str) -> GridSpec:
    """--fisr_grid grammar: 'full' -> None (untiled full-frame apply),
    'auto' and 'tuned' pass through as mode strings (resolved by
    infer/video.resolve_fisr_plan), anything else is 'GH,GW'."""
    if s == "full":
        return None
    if s in ("auto", "tuned"):
        return s
    gh, gw = (int(v) for v in s.split(","))
    return (gh, gw)
