"""Device selection and numeric policy for the port's entry points: explicit,
never silent.

`resolve_device` turns a device name into a torch.device and raises where it
names a card that is not there.

`exact_f32` and `cudnn_deterministic` set PyTorch's global backend flags for
the length of a block and restore them after it:

- f32 means f32. PyTorch runs an f32 convolution through cuDNN in TF32 by
  default (`torch.backends.cudnn.allow_tf32` is True), which keeps about three
  decimal digits; the reference's TF1 graphs and the JAX package compute in
  full f32. Every entry point of the port that computes in f32 (the CLI's f32
  phases, serving and tuning under float32, the corpus tools, `fit` and
  `pwc_fit` under an f32 policy) runs inside `exact_f32`; bf16 paths leave the
  flags alone. There is no switch back to TF32.
- The corpus tools reproduce. cuDNN's default algorithms for PWC-Net's
  transposed convolutions may add in another order from one call to the
  next; `cli/prepare` and `cli/build_corpus` run inside `cudnn_deterministic`.

The flags are process-wide, not per thread. So a scope counts the threads
inside it: the first to enter saves the flags, every entrant sets them, and
the last to leave restores them. Two services of one process that run at once
on two cards (infer/daemon.MultiChipService) keep the flags set until both
are done.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["resolve_device", "exact_f32", "cudnn_deterministic", "f32_scope"]


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


_FLAGS = {
    "cudnn.allow_tf32": (torch.backends.cudnn, "allow_tf32"),
    "matmul.allow_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
    "cudnn.deterministic": (torch.backends.cudnn, "deterministic"),
}
_lock = threading.Lock()
_held = {}  # flag -> [threads inside a scope that sets it, the value saved by the first]


@contextlib.contextmanager
def _flags(value: bool, *names: str):
    with _lock:
        for name in names:
            mod, attr = _FLAGS[name]
            held = _held.setdefault(name, [0, None])
            if held[0] == 0:
                held[1] = getattr(mod, attr)
            held[0] += 1
            setattr(mod, attr, value)
    try:
        yield
    finally:
        with _lock:
            for name in names:
                mod, attr = _FLAGS[name]
                held = _held[name]
                held[0] -= 1
                if held[0] == 0:
                    setattr(mod, attr, held[1])


def exact_f32():
    """TF32 off for cuDNN's convolutions and cuBLAS's matrix products inside
    the block; both flags restored after it."""
    return _flags(False, "cudnn.allow_tf32", "matmul.allow_tf32")


def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block; the flag restored
    after it."""
    return _flags(True, "cudnn.deterministic")


def f32_scope(policy):
    """`exact_f32()` where `policy` computes in f32, else a block that
    changes nothing."""
    if policy.compute_dtype == torch.float32:
        return exact_f32()
    return contextlib.nullcontext()
