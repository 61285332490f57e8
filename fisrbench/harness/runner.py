"""What a traffic driver gets and gives back, and the pieces every driver
shares: seeded weights made on the card, the numbers compared with their
limits, and the process's CPU clock."""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from fisrbench.reference.ops import glorot_std

SEED_MASK = (1 << 63) - 1


def device_generator(device: torch.device, seed: int, tag: int) -> torch.Generator:
    """A device generator for one purpose (tag) of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.default_rng([seed & SEED_MASK, tag]).integers(0, 2**63 - 1)))
    return g


@dataclasses.dataclass
class RunContext:
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # time.perf_counter() at process start

    def rng(self, tag: int) -> np.random.Generator:
        """A host generator for one purpose of this run (tag), from the seed."""
        return np.random.default_rng([self.seed & SEED_MASK, tag])

    def generator(self, tag: int) -> torch.Generator:
        """A device generator for one purpose of this run (tag), from the seed."""
        return device_generator(self.device, self.seed, tag)


@dataclasses.dataclass
class Outcome:
    setup_s: float
    e2e: dict                    # end-to-end metric -> value (setup_s apart)
    attempted: int
    failed: int
    checks: list                 # (name, value, limit): correct needs value <= limit
    memory_peak_bytes: int
    reading: dict                # what the per-layer readers read (trace runs)

    @property
    def correct(self) -> bool:
        return judged(self.checks, self.failed)


def judged(checks, failed: int) -> bool:
    """`correct`: nothing failed, and every number compared is within its limit."""
    return failed == 0 and all(v <= lim for _n, v, lim in checks)


def seeded_params(shapes: dict, gen: torch.Generator, device) -> dict:
    """Glorot-normal kernels and zero biases (the models' own initialisers),
    drawn on the device in one call: {name: f32 tensor}, names in sorted
    order."""
    names = sorted(shapes)
    kernels = [n for n in names if len(shapes[n]) == 4]
    total = sum(int(np.prod(shapes[n])) for n in kernels)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for n in names:
        s = shapes[n]
        if len(s) == 4:
            k = int(np.prod(s))
            out[n] = flat[off:off + k].view(s) * glorot_std(s)
            off += k
        else:
            out[n] = torch.zeros(s, device=device)
    return out


def load_into(model: torch.nn.Module, params: dict) -> None:
    """Copy `params` into the program's module; every name must match."""
    missing = model.load_state_dict({k: v for k, v in params.items()}, strict=True)
    if missing.missing_keys or missing.unexpected_keys:
        raise KeyError(f"parameter names differ: {missing}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    """The allocator's peak on `device` since the process started (0 off the card)."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def cpu_seconds() -> float:
    """User + system CPU time of this process, all threads."""
    t = os.times()
    return t.user + t.system


class Window:
    """The measured window: `open()` at its start, `done()` tells whether
    `seconds` have passed, `close()` at the end of the unit in progress."""

    def __init__(self, seconds: float, device: torch.device):
        self.seconds = seconds
        self.device = device

    def open(self):
        sync(self.device)
        self.t0 = time.perf_counter()
        return self

    def done(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds

    def close(self) -> float:
        sync(self.device)
        self.t1 = time.perf_counter()
        return self.t1 - self.t0
