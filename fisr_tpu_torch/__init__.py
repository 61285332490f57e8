"""fisr_tpu_torch: the PyTorch/CUDA build of fisr_tpu for an NVIDIA H100.

Module paths and function names mirror `fisr_tpu` so that each function has
an obvious counterpart there; the JAX package is the reference every port
module is tested against. Tensors are NHWC at public function boundaries.
Entry points take an explicit `device` (default "cuda") and raise when the
card is missing: nothing falls back to the CPU unless the caller asks for it.
"""

from fisr_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
