"""Tiling autotuner (port of fisr_tpu/infer/autotune.py): measure which
FISRnet window plan is fastest on the attached card and keep the answer.

The tiling rules the port inherits (`best_grid`'s (4, 6) target,
`padded_grid`'s 10 % pad budget) were measured on the JAX package's own
hardware. `sweep` times every candidate plan of a window size on the card
(CUDA events; the host clock on the CPU), and `TuneCache` keeps the table,
keyed by (device kind, frame, dtype, boundary), so that a deployment tunes
once and `fisr_grid='tuned'` (infer/video.resolve_fisr_plan) serves the
winner.

The cache is the port's own (`~/.cache/fisr_tpu_torch/autotune.json`), in the
JAX package's JSON format. The JAX package ships measured TPU plans beside its
module; the port ships none (`SHIPPED_CACHE_PATH` names no file), so an
untuned frame size falls back to the heuristic.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fisr_tpu_torch.device import resolve_device
from fisr_tpu_torch.infer.device import make_device_runner, tiled_apply_padded
from fisr_tpu_torch.models import fisrnet
from fisr_tpu_torch.ops.conv import F32, Policy

__all__ = ["candidate_grids", "padded_candidates", "sweep", "TuneCache",
           "DEFAULT_CACHE_PATH", "dtype_name"]

DEFAULT_CACHE_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "fisr_tpu_torch", "autotune.json")

# plans shipped with the package, loaded under the local cache; the port
# ships none, so this names no file
SHIPPED_CACHE_PATH = os.path.join(os.path.dirname(__file__), "autotune_shipped.json")


def dtype_name(policy: Policy) -> str:
    """The cache key's dtype word: 'float32' or 'bfloat16', as numpy names
    the JAX policy's dtype."""
    return str(policy.compute_dtype).replace("torch.", "")


def candidate_grids(h: int, w: int, max_gh: int = 6, max_gw: int = 8
                    ) -> List[Tuple[int, int]]:
    """All grids whose patches stay 32-multiples (the /4 pyramid and halo
    contract `best_grid` enforces), including the untiled (1, 1)."""
    if h % 32 or w % 32:
        raise ValueError(f"frame {h}x{w} must be 32-multiples")
    ghs = [g for g in range(1, max_gh + 1) if h % (32 * g) == 0]
    gws = [g for g in range(1, max_gw + 1) if w % (32 * g) == 0]
    return [(gh, gw) for gh in ghs for gw in gws]


def padded_candidates(h: int, w: int, max_gh: int = 6, max_gw: int = 8,
                      max_pad_frac: float = 0.125
                      ) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """[(grid, (pad_h, pad_w)), ...] for the grids only a bottom/right pad of
    at most `max_pad_frac` of an axis reaches (device.tiled_apply_padded).
    Pad-free grids are left to `candidate_grids`."""
    if h % 32 or w % 32:
        raise ValueError(f"frame {h}x{w} must be 32-multiples")
    out = []
    for gh in range(1, max_gh + 1):
        ph = (-h) % (32 * gh)
        if ph > max_pad_frac * h:
            continue
        for gw in range(1, max_gw + 1):
            pw = (-w) % (32 * gw)
            if pw > max_pad_frac * w or not (ph or pw):
                continue
            out.append(((gh, gw), (ph, pw)))
    return out


def _time_runner(fn, model, x, reps: int) -> float:
    """Median seconds of `fn(model, x)` over `reps` calls after a warm one:
    CUDA events on the card, the host clock on the CPU."""
    fn(model, x)
    ts = []
    for _ in range(reps):
        if x.is_cuda:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(model, x)
            stop.record()
            stop.synchronize()
            ts.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(model, x)
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def sweep(params: fisrnet.FISRnet, h: int, w: int, *, policy: Optional[Policy] = None,
          boundary: int = 32, sf: int = 2, reps: int = 3, batch: int = 1,
          grids: Optional[List[Tuple[int, int]]] = None, max_gh: int = 6, max_gw: int = 8,
          verbose: bool = False, device="cuda") -> List[dict]:
    """Time every candidate plan of an (h, w) window on `device` (the model
    is moved there); returns [{grid, pad, sec, mode}, ...], fastest first.

    (1, 1) runs as the untiled full-frame apply. Without `grids` the
    candidates are `candidate_grids` and `padded_candidates` up to (max_gh,
    max_gw); `grids` names pad-free grids to time instead. A candidate that
    runs out of device memory is skipped (and said, with `verbose`); any
    other error propagates.
    """
    dev = resolve_device(device)
    policy = policy or F32
    model = params.to(dev)
    plans = ([(tuple(g), (0, 0)) for g in grids] if grids is not None
             else [(g, (0, 0)) for g in candidate_grids(h, w, max_gh, max_gw)]
             + padded_candidates(h, w, max_gh, max_gw))
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((batch, h, w, fisrnet.IN_CH), generator=gen).to(dev, policy.compute_dtype)

    results = []
    for grid, pads in plans:
        if pads != (0, 0):
            mode = "padded"
            fn = torch.no_grad()(lambda m, v, g=grid, pd=pads: tiled_apply_padded(
                m, v, g, pd, boundary, sf, policy))
        else:
            mode = "full" if grid == (1, 1) else "tiled"
            fn = make_device_runner(mode, grid=grid, boundary=boundary, sf=sf, policy=policy)
        try:
            sec = _time_runner(fn, model, x, reps)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            if verbose:
                print(f"# grid {grid} pad {pads}: out of device memory, skipped")
            continue
        results.append({"grid": list(grid), "pad": list(pads), "sec": round(sec, 5),
                        "mode": mode})
        if verbose:
            print(f"# grid {grid} pad {pads}: {sec * 1e3:8.2f} ms ({mode})")
    results.sort(key=lambda r: r["sec"])
    if not results:
        raise RuntimeError("autotune sweep: every candidate grid failed")
    return results


class TuneCache:
    """Persisted sweep results keyed by device kind + measurement config.

    `best_plan(h, w)` returns the measured winner for this device kind, or
    None if that frame size was never tuned here (callers fall back to the
    `padded_grid` heuristic). `device` names the device whose kind keys the
    entries (and that `tune` measures on)."""

    def __init__(self, path: Optional[str] = None,
                 shipped_path: Optional[str] = SHIPPED_CACHE_PATH, device="cuda"):
        # default resolved at call time so tests and deployments can repoint it
        path = path or DEFAULT_CACHE_PATH
        self.path = path
        self.device = device
        self._data: Dict[str, dict] = {}
        self._local: Dict[str, dict] = {}
        # shipped entries load first; a local tune for the same key wins
        # (tune() persists only local entries, never the shipped ones)
        if shipped_path and os.path.exists(shipped_path):
            with open(shipped_path) as f:
                self._data.update(json.load(f))
        if os.path.exists(path):
            with open(path) as f:
                self._local = json.load(f)
            self._data.update(self._local)

    @staticmethod
    def _device_kind(device="cuda") -> str:
        """The card's name (torch.cuda.get_device_name), or 'cpu': what the
        JAX package's device_kind reads on its CPU backend."""
        dev = resolve_device(device)
        return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def _key(self, h: int, w: int, dtype: str, boundary: int) -> str:
        return f"{self._device_kind(self.device)}|{h}x{w}|{dtype}|b{boundary}"

    def best_plan(self, h: int, w: int, dtype: str = "bfloat16", boundary: int = 32
                  ) -> Optional[Tuple[Tuple[int, int], Tuple[int, int]]]:
        """Fastest (grid, (pad_h, pad_w)) overall, padded entries included
        (what video.resolve_fisr_plan serves for 'tuned')."""
        entry = self._data.get(self._key(h, w, dtype, boundary))
        if not entry:
            return None
        r = entry["results"][0]
        return tuple(r["grid"]), tuple(r.get("pad", (0, 0)))

    def tune(self, params: fisrnet.FISRnet, h: int, w: int, *,
             policy: Optional[Policy] = None, boundary: int = 32, reps: int = 3,
             grids: Optional[List[Tuple[int, int]]] = None, max_gh: int = 6,
             max_gw: int = 8, verbose: bool = False) -> Optional[Tuple[int, int]]:
        """Sweep on this cache's device (`sweep`'s candidates, or `grids`),
        persist, and return the winning pad-free grid, or None when every
        pad-free candidate ran out of memory. The overall winner, possibly
        padded, is what `best_plan` serves."""
        policy = policy or F32
        key = self._key(h, w, dtype_name(policy), boundary)
        results = sweep(params, h, w, policy=policy, boundary=boundary, reps=reps, grids=grids,
                        max_gh=max_gh, max_gw=max_gw, verbose=verbose, device=self.device)
        entry = {"results": results, "reps": reps}
        self._data[key] = entry
        self._local[key] = entry
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._local, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        padfree = [r for r in results if tuple(r.get("pad", (0, 0))) == (0, 0)]
        return tuple(padfree[0]["grid"]) if padfree else None
