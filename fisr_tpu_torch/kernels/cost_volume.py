"""PWC-Net cost volume on the card: wrapper of fisr_tpu_torch/csrc/cost_volume.cu,
the Hopper kernel that replaces fisr_tpu/kernels/cost_volume_pallas.py.

The library holds two forward kernels, chosen by type alone: bf16 pairs take
the tensor-core kernel (a banded `mma.sync` product, variant "mma_bf16"), f32
pairs the CUDA-core kernel (variant "fma_f32"); and two backward kernels,
also by type, each computing both input gradients in one launch and each
streaming the source rows a tile needs: f32 through register tiles on the
CUDA cores (variant "bwd_f32"), bf16 as banded `mma.sync` products on the
tensor cores (variant "bwd_bf16").

`cost_volume` takes the kernel for CUDA tensors and the plain version
(fisr_tpu_torch/ops/cost_volume.py) for CPU tensors; `cost_volume_cuda`
takes the kernel or raises. Nothing falls back: a CUDA tensor that the kernel
cannot take, a failed build or a refused launch raises.

The backward of `cost_volume_cuda` is the backward kernel (the JAX package's
custom VJP, `_cv_bwd`, is an XLA composition of the same function); its plain
version is fisr_tpu_torch/ops/cost_volume.cost_volume_backward. CPU tensors
never reach it: `cost_volume` gives them the plain version and its autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fisr_tpu_torch.kernels import build
from fisr_tpu_torch.ops.cost_volume import cost_volume as cost_volume_plain

__all__ = ["cost_volume", "cost_volume_cuda", "cost_volume_backward_cuda", "LAUNCHES",
           "LAUNCHES_BY_VARIANT", "BACKWARD_LAUNCHES", "BACKWARD_LAUNCHES_BY_VARIANT",
           "SEARCH_RANGES"]

# kernel launches made by this process (the main path's count is read from
# here), in all and by the kernel that the input type selects: forward
# launches, and apart from them backward launches
LAUNCHES = 0
LAUNCHES_BY_VARIANT = {"mma_bf16": 0, "fma_f32": 0}
BACKWARD_LAUNCHES = 0
BACKWARD_LAUNCHES_BY_VARIANT = {"bwd_f32": 0, "bwd_bf16": 0}
SEARCH_RANGES = (2, 4)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {torch.float32: "fma_f32", torch.bfloat16: "mma_bf16"}
_BACKWARD_VARIANTS = {torch.float32: "bwd_f32", torch.bfloat16: "bwd_bf16"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    lib = build.load("cost_volume")
    lib.fisr_cost_volume.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.fisr_cost_volume.restype = ctypes.c_int
    lib.fisr_cost_volume_backward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                              + [ctypes.c_void_p])
    lib.fisr_cost_volume_backward.restype = ctypes.c_int
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
    _raise_for(lib, err, "cost-volume kernel")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[_VARIANTS[c1.dtype]] += 1
    return out


def _raise_for(lib, err: int, what: str) -> None:
    if err:
        msg = lib.fisr_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _launch_backward(c1: torch.Tensor, c2: torch.Tensor, g: torch.Tensor, d: int,
                     need1: bool = True, need2: bool = True):
    """(dc1, dc2) from the backward kernel; None for a gradient not asked for."""
    global BACKWARD_LAUNCHES
    _check(c1, c2, d)
    b, h, w, c = c1.shape
    want = (b, h, w, (2 * d + 1) ** 2)
    if g.device != c1.device or g.dtype != c1.dtype or tuple(g.shape) != want:
        raise ValueError(f"cost-volume backward needs g {want} {c1.dtype} on {c1.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    if c1.device.index != torch.cuda.current_device():
        with torch.cuda.device(c1.device):
            return _launch_backward(c1, c2, g, d, need1, need2)
    g = g.contiguous()
    lib = _lib()
    dc1 = torch.empty_like(c1) if need1 else None
    dc2 = torch.empty_like(c2) if need2 else None
    if not (need1 or need2):
        return dc1, dc2
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.fisr_cost_volume_backward(
        c1.data_ptr(), c2.data_ptr(), g.data_ptr(), dc1.data_ptr() if need1 else None,
        dc2.data_ptr() if need2 else None, b, h, w, c, d, _DTYPES[c1.dtype], stream)
    _raise_for(lib, err, "cost-volume backward kernel")
    BACKWARD_LAUNCHES += 1
    BACKWARD_LAUNCHES_BY_VARIANT[_BACKWARD_VARIANTS[c1.dtype]] += 1
    return dc1, dc2


class _CostVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c1, c2, d):
        ctx.save_for_backward(c1, c2)
        ctx.d = d
        return _launch(c1, c2, d)

    @staticmethod
    def backward(ctx, g):
        c1, c2 = ctx.saved_tensors
        need1, need2, _ = ctx.needs_input_grad
        dc1, dc2 = _launch_backward(c1, c2, g, ctx.d, need1, need2)
        return dc1, dc2, None


def cost_volume_cuda(c1: torch.Tensor, c2: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """The Hopper kernel: c1, c2 [B, H, W, C] CUDA, contiguous, f32 or bf16 ->
    [B, H, W, (2d+1)^2]. Raises for anything else, CPU tensors included."""
    return _CostVolume.apply(c1, c2, search_range)


def cost_volume_backward_cuda(c1: torch.Tensor, c2: torch.Tensor, g: torch.Tensor,
                              search_range: int = 4):
    """The backward kernel: (dc1, dc2) of `cost_volume_cuda` for the output
    gradient g, on CUDA tensors of one type. Raises for anything else."""
    return _launch_backward(c1, c2, g, search_range)


def cost_volume(c1: torch.Tensor, c2: torch.Tensor, search_range: int = 4) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if c1.device.type == "cpu" and c2.device.type == "cpu":
        return cost_volume_plain(c1, c2, search_range)
    return cost_volume_cuda(c1, c2, search_range)
