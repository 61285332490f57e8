"""Device selection for the port's entry points: explicit, never silent."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is no card.

    The port never falls back to the CPU on its own: a caller that wants the
    CPU passes device="cpu".
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
