"""PWC-Net cost volume on the card: wrapper of fisr_tpu_torch/csrc/cost_volume.cu,
the Hopper kernel that replaces fisr_tpu/kernels/cost_volume_pallas.py.

The library holds two kernels, chosen by type alone: bf16 pairs take the
tensor-core kernel (a banded `mma.sync` product, variant "mma_bf16"), f32
pairs the CUDA-core kernel (variant "fma_f32").

`cost_volume` takes the kernel for CUDA tensors and the plain version
(fisr_tpu_torch/ops/cost_volume.py) for CPU tensors; `cost_volume_cuda`
takes the kernel or raises. Nothing falls back: a CUDA tensor that the kernel
cannot take, a failed build or a refused launch raises.

The backward differentiates the plain version, as the JAX package's custom
VJP (`_cv_bwd`) differentiates its XLA composition.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fisr_tpu_torch.kernels import build
from fisr_tpu_torch.ops.cost_volume import cost_volume as cost_volume_plain

__all__ = ["cost_volume", "cost_volume_cuda", "LAUNCHES", "LAUNCHES_BY_VARIANT",
           "SEARCH_RANGES"]

# kernel launches made by this process (the main path's count is read from
# here), in all and by the kernel that the input type selects
LAUNCHES = 0
LAUNCHES_BY_VARIANT = {"mma_bf16": 0, "fma_f32": 0}
SEARCH_RANGES = (2, 4)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {torch.float32: "fma_f32", torch.bfloat16: "mma_bf16"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    lib = build.load("cost_volume")
    lib.fisr_cost_volume.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.fisr_cost_volume.restype = ctypes.c_int
    lib.fisr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fisr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(c1: torch.Tensor, c2: torch.Tensor, d: int) -> None:
    if not (c1.is_cuda and c2.is_cuda) or c1.device != c2.device:
        raise ValueError(f"cost-volume kernel needs both inputs on one CUDA device, "
                         f"got {c1.device} and {c2.device}")
    if c1.dtype not in _DTYPES or c2.dtype != c1.dtype:
        raise TypeError(f"cost-volume kernel takes float32 or bfloat16 pairs, "
                        f"got {c1.dtype} and {c2.dtype}")
    if c1.ndim != 4 or c1.shape != c2.shape or min(c1.shape) < 1:
        raise ValueError(f"cost-volume kernel needs two equal non-empty [B, H, W, C] "
                         f"shapes, got {tuple(c1.shape)} and {tuple(c2.shape)}")
    if not (c1.is_contiguous() and c2.is_contiguous()):
        raise ValueError("cost-volume kernel needs contiguous NHWC inputs")
    if d not in SEARCH_RANGES:
        raise ValueError(f"cost-volume kernel takes search_range in {SEARCH_RANGES}, got {d}")
    b, h = c1.shape[0], c1.shape[1]
    if b > 65535 or h > 65535:
        raise ValueError(f"cost-volume kernel grid limit exceeded by {tuple(c1.shape)}")


def _launch(c1: torch.Tensor, c2: torch.Tensor, d: int) -> torch.Tensor:
    global LAUNCHES
    _check(c1, c2, d)
    if c1.device.index != torch.cuda.current_device():
        # the library launches on the current device; entering the guard on
        # every call would cost more host time than the small levels take
        with torch.cuda.device(c1.device):
            return _launch(c1, c2, d)
    lib = _lib()
    b, h, w, c = c1.shape
    out = torch.empty((b, h, w, (2 * d + 1) ** 2), dtype=c1.dtype, device=c1.device)
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.fisr_cost_volume(c1.data_ptr(), c2.data_ptr(), out.data_ptr(), b, h, w,
                               c, d, _DTYPES[c1.dtype], stream)
    if err:
        msg = lib.fisr_cuda_error_string(err).decode()
        raise RuntimeError(f"cost-volume kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[_VARIANTS[c1.dtype]] += 1
    return out


class _CostVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c1, c2, d):
        ctx.save_for_backward(c1, c2)
        ctx.d = d
        return _launch(c1, c2, d)

    @staticmethod
    def backward(ctx, g):
        c1, c2 = ctx.saved_tensors
        with torch.enable_grad():
            a = c1.detach().requires_grad_(True)
            b = c2.detach().requires_grad_(True)
            ga, gb = torch.autograd.grad(cost_volume_plain(a, b, ctx.d), (a, b), g)
        return ga, gb, None


def cost_volume_cuda(c1: torch.Tensor, c2: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """The Hopper kernel: c1, c2 [B, H, W, C] CUDA, contiguous, f32 or bf16 ->
    [B, H, W, (2d+1)^2]. Raises for anything else, CPU tensors included."""
    return _CostVolume.apply(c1, c2, search_range)


def cost_volume(c1: torch.Tensor, c2: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if c1.device.type == "cpu" and c2.device.type == "cpu":
        return cost_volume_plain(c1, c2, search_range)
    return cost_volume_cuda(c1, c2, search_range)
