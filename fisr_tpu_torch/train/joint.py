"""End-to-end joint fine-tuning: gradients through flow -> warp -> FISRnet
(port of fisr_tpu/train/joint.py).

A capability the reference CANNOT express: its video path is three separate
TF sessions handing off .flo/.mat files through disk (main.py:207-235), so
the flow model can never receive gradients from the interpolation loss.
Here the serving path IS one differentiable program
(infer/video._fisr_window_core over _flow_core/_warp_core), so FISRnet and
PWC-Net can be fine-tuned jointly against the final frame quality.

Differentiability: the cost-volume kernel's autograd.Function
differentiates the plain version in its backward (kernels/cost_volume.py);
dense_image_warp is differentiable in both arguments (ops/warp); the
bilinear x2 upscale and the colour transforms are linear.

Train on the deployment window contract: frames [B, 3, h, w, 3] YUV in
[0, 255], target [B, sf*h, sf*w, 9] in [0, 1] ([fr1, SR, fr2], the video
phase's output). Loss is Charbonnier (sqrt(x^2+eps^2), the robust L1
standard for VFI fine-tuning) or plain L2.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from fisr_tpu_torch.core.mesh import average_gradients_, mean_metrics
from fisr_tpu_torch.infer.video import _fisr_window_core, _flow_core, _warp_core
from fisr_tpu_torch.models import fisrnet, pwcnet
from fisr_tpu_torch.ops.conv import F32, Policy
from fisr_tpu_torch.ops.metrics import psnr_image
from fisr_tpu_torch.train.trainer import TFAdam, batch_to_device, device_of

__all__ = ["JointState", "create_joint_state", "make_joint_train_step"]


@dataclasses.dataclass
class JointState:
    """Both models, their optimizers (pwc_opt None = the flow model is
    frozen) and the global step."""

    fisr_model: fisrnet.FISRnet
    pwc_model: pwcnet.PWCNet
    fisr_opt: TFAdam
    pwc_opt: Optional[TFAdam]
    step: int = 0


def create_joint_state(fisr_model: fisrnet.FISRnet, pwc_model: pwcnet.PWCNet,
                       fisr_optimizer: Callable[..., TFAdam],
                       pwc_optimizer: Optional[Callable[..., TFAdam]]) -> JointState:
    """The optimizers are factories over parameters (trainer.tf_adam);
    pwc_optimizer=None freezes the flow model."""
    return JointState(
        fisr_model, pwc_model,
        fisr_optimizer(fisr_model.parameters()),
        pwc_optimizer(pwc_model.parameters()) if pwc_optimizer is not None else None,
        0,
    )


def _charbonnier(err: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    return torch.mean(torch.sqrt(err * err + eps * eps))


def make_joint_train_step(
    cfg: Optional[pwcnet.PWCNetConfig] = None,
    policy: Policy = F32,
    upscale: int = 2,
    sf: int = 2,
    loss: str = "charbonnier",
    mesh=None,
) -> Callable[[JointState, Dict[str, torch.Tensor]],
              Tuple[JointState, Dict[str, torch.Tensor]]]:
    """One joint step over the FULL serving path, the state updated in place.

    A state without a flow optimizer (pwc_opt None) trains FISRnet alone on
    in-graph flows: the flow stage then runs without autograd, and FISRnet
    gets the gradients it would get with it. Still useful: the interpolator
    adapts to the flow model's actual error distribution instead of the
    corpus's offline flows. batch: {"frames": [B,3,h,w,3] YUV [0,255],
    "target": [B, sf*h, sf*w, 9] in [0,1]}. cfg=None is the flow model's own.

    With a `mesh`, data-parallel over 'data' as trainer.make_train_step: the
    batch is this rank's rows, the gradients of the models that train (not a
    frozen flow model's) and the metrics are averaged over the axis.
    """
    loss_fn_px = _charbonnier if loss == "charbonnier" else (lambda e: torch.mean(e * e))

    def forward(fisr_model, pwc_model, frames, train_pwc):
        f0, f1, f2 = frames[:, 0], frames[:, 1], frames[:, 2]
        pwc_cfg = cfg or pwc_model.cfg
        with contextlib.nullcontext() if train_pwc else torch.no_grad():
            flows01 = _flow_core(pwc_model, f0, f1, pwc_cfg, policy, upscale)
            flows12 = _flow_core(pwc_model, f1, f2, pwc_cfg, policy, upscale)
        warps01 = _warp_core(f0, f1, flows01)
        warps12 = _warp_core(f1, f2, flows12)
        return _fisr_window_core(fisr_model, f0, f1, f2, flows01, warps01,
                                 flows12, warps12, policy, sf, None,
                                 clip_output=False)

    def step_fn(state: JointState, batch):
        train_pwc = state.pwc_opt is not None
        batch = batch_to_device(batch, device_of(state.fisr_model))
        state.fisr_opt.zero_grad(set_to_none=True)
        if train_pwc:
            state.pwc_opt.zero_grad(set_to_none=True)
        pred = forward(state.fisr_model, state.pwc_model, batch["frames"], train_pwc)
        total = loss_fn_px(pred - batch["target"])
        with torch.no_grad():
            psnr = torch.mean(psnr_image(pred.clamp(0.0, 1.0), batch["target"]))
        total.backward()
        metrics = {"joint_loss": total.detach(), "joint_PSNR": psnr}
        if mesh is not None:
            trained = list(state.fisr_model.parameters())
            if train_pwc:
                trained += list(state.pwc_model.parameters())
            average_gradients_(trained, mesh)
            metrics = mean_metrics(metrics, mesh)
        state.fisr_opt.step()
        if train_pwc:
            state.pwc_opt.step()
        state.step += 1
        return state, metrics

    return step_fn
