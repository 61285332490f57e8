"""PWC-Net training/eval engine (port of fisr_tpu/train/pwc_trainer.py).

A rebuild of the tfoptflow training stack (model_pwcnet.py:587-885
train/eval loops, model_base.py lifecycle):

* one train step: multiscale or robust pyramid loss (train/pwc_loss) +
  TF-form Adam;
* EPE validation step (the reference's ranking metric for
  BestCheckpointSaver);
* mixed precision: bf16 activations / f32 params via the Policy, replacing
  the reference's fp16 + fp32-master-weights + static loss scaling
  (model_base.py:232-233, model_pwcnet.py:539-547): bf16's exponent range
  makes the loss scaler unnecessary.

On CUDA tensors the forward launches the cost-volume kernel at every pyramid
level (kernels/cost_volume.py, never the plain version) and the backward its
backward kernel, the JAX package's custom VJP. On a card the train step is
captured once as a CUDA graph and replayed (`make_pwc_train_step`).
`cfg=None` means the model's own configuration.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from fisr_tpu_torch.convert.params import train_state_tree
from fisr_tpu_torch.core.mesh import average_gradients_, mean_metrics
from fisr_tpu_torch.data.flo import write_flo
from fisr_tpu_torch.data.png_io import write_png
from fisr_tpu_torch.device import f32_scope
from fisr_tpu_torch.models import pwcnet
from fisr_tpu_torch.ops.conv import F32, Policy
from fisr_tpu_torch.ops.warp import dense_image_warp
from fisr_tpu_torch.train import schedule as sched
from fisr_tpu_torch.train.checkpoint import CheckpointManager
from fisr_tpu_torch.train.loop import prefetch_to_device
from fisr_tpu_torch.train.pwc_loss import epe, pwcnet_loss
from fisr_tpu_torch.train.trainer import (TFAdam, TrainState, _StepGraph, batch_to_device,
                                          device_of, tf_adam)
from fisr_tpu_torch.utils import profiling
from fisr_tpu_torch.utils.flow_viz import flow_panels, flow_to_img
from fisr_tpu_torch.utils.tb_writer import TBLogger

__all__ = ["create_pwc_state", "make_pwc_train_step", "make_pwc_eval_step",
           "pwc_eval_report", "pwc_fit"]


def create_pwc_state(seed: int, optimizer: Callable[..., TFAdam],
                     cfg: pwcnet.PWCNetConfig = pwcnet.PWCNetConfig(),
                     device="cuda") -> TrainState:
    model = pwcnet.PWCNet(cfg, seed=seed, device=device)
    return TrainState(model, optimizer(model.parameters()), 0)


def make_pwc_train_step(cfg: Optional[pwcnet.PWCNetConfig] = None,
                        policy: Policy = F32, loss_mode: str = "multiscale",
                        gamma: float = 0.0004, q: float = 0.4,
                        epsilon: float = 0.01, mesh=None, graph: bool = True):
    """step(state, batch) -> (state, {'loss'}), the state updated in place.
    batch: {'x': [B, 2, H, W, 3] in [0,1], 'y': [B, H, W, 2] GT flow}.

    With a `mesh`, data-parallel over 'data' as trainer.make_train_step: the
    batch is this rank's rows, the gradients (the weight decay's, the same
    on every rank, included) and the loss are averaged over the axis.

    On a CUDA model without a mesh the step is one CUDA graph (`_StepGraph`):
    the first two calls run eagerly, the third captures forward, loss,
    backward and the TFAdam update and replays it, and later calls with the
    same state and batch shapes replay it. `graph=False` keeps every call
    eager. The loss returned is a copy, so it keeps its step's value. Counters
    (utils/profiling): `train.steps` every call, `train.graph_captures`,
    `train.graph_replays`."""

    def forward_backward(model, batch) -> Dict[str, torch.Tensor]:
        _, pyr = pwcnet.apply(model, batch["x"][:, 0], batch["x"][:, 1],
                              cfg or model.cfg, policy)
        loss = pwcnet_loss(batch["y"], pyr, list(model.parameters()), mode=loss_mode,
                           gamma=gamma, q=q, epsilon=epsilon)
        loss.backward()
        return {"loss": loss.detach()}

    def eager(state: TrainState, batch) -> Dict:
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        metrics = forward_backward(model, batch)
        if mesh is not None:
            average_gradients_(model.parameters(), mesh)
            metrics = mean_metrics(metrics, mesh)
        opt.step()
        return metrics

    graphed = _StepGraph(forward_backward, eager) if graph and mesh is None else None

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        profiling.count("train.steps")
        dev = device_of(state.model)
        batch = batch_to_device(batch, dev)
        if graphed is not None and dev.type == "cuda":
            metrics = graphed(state, batch)
        else:
            metrics = eager(state, batch)
        state.step += 1
        return state, metrics

    return step_fn


def make_pwc_eval_step(cfg: Optional[pwcnet.PWCNetConfig] = None, policy: Policy = F32):
    @torch.no_grad()
    def eval_fn(model: pwcnet.PWCNet, batch) -> Dict[str, torch.Tensor]:
        batch = batch_to_device(batch, device_of(model))
        flow_pred, _ = pwcnet.apply(model, batch["x"][:, 0], batch["x"][:, 1],
                                    cfg or model.cfg, policy)
        return {"epe": epe(flow_pred, batch["y"])}

    return eval_fn


@torch.no_grad()
def pwc_eval_report(model: pwcnet.PWCNet, dataset, batch_size: int = 8,
                    cfg: Optional[pwcnet.PWCNetConfig] = None,
                    policy: Policy = F32, save_preds_dir: str | None = None,
                    report_path: str | None = None):
    """Per-sample validation report, model_pwcnet.py:817-885 parity.

    The reference's eval() returns (avg metric, avg duration, pandas df with
    ID / EPE / Duration / Avg_Flow_Mag / Max_Flow_Mag rows, optionally
    writing .flo + flow-viz png predictions). Same here, with the rows as a
    list of dicts (JSONL on disk instead of a dataframe), and the whole val
    batch scored in one call per round. Duration is taken after the EPEs
    have come back to the host, so the device's work is inside it.

    Returns (avg_epe, avg_duration_sec, rows).
    """
    dev = device_of(model)
    cfg = cfg or model.cfg
    ids = getattr(dataset, "ids", None)
    rows = []
    idx = 0
    if save_preds_dir:
        os.makedirs(save_preds_dir, exist_ok=True)
    for vb in dataset.batches(batch_size, train=False):
        t0 = time.time()
        vb = batch_to_device(vb, dev)
        flows, _ = pwcnet.apply(model, vb["x"][:, 0], vb["x"][:, 1], cfg, policy)
        flows = flows.float()
        d = flows - vb["y"].float()
        epes = torch.mean(torch.sqrt(torch.sum(d * d, -1)), dim=(1, 2))
        mag = torch.sqrt(torch.sum(torch.square(flows), -1))
        epes = epes.cpu().numpy()  # fences the device work
        duration = (time.time() - t0) / len(epes)
        avg_mag = torch.mean(mag, dim=(1, 2)).cpu().numpy()
        max_mag = torch.amax(mag, dim=(1, 2)).cpu().numpy()
        for k in range(len(epes)):
            sample_id = (ids[dataset.train_size + idx]
                         if ids is not None else f"val_{idx:05d}")
            rows.append({"ID": sample_id, "EPE": float(epes[k]),
                         "Duration": float(duration),
                         "Avg_Flow_Mag": float(avg_mag[k]),
                         "Max_Flow_Mag": float(max_mag[k])})
            if save_preds_dir:
                pred = flows[k].cpu().numpy()
                write_flo(pred, os.path.join(save_preds_dir, f"{sample_id}_flow_pred.flo"))
                write_png(flow_to_img(pred),
                          os.path.join(save_preds_dir, f"{sample_id}_flow_pred.png"))
            idx += 1
    avg_epe = sum(r["EPE"] for r in rows) / max(len(rows), 1)
    avg_dur = sum(r["Duration"] for r in rows) / max(len(rows), 1)
    if report_path:
        with open(report_path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return avg_epe, avg_dur, rows


def pwc_fit(dataset, ckpt_dir: str, steps: int, batch_size: int = 8,
            val_every: int = 1000, display_every: int = 100,
            schedule_fn=None, cfg: pwcnet.PWCNetConfig = pwcnet.PWCNetConfig(),
            policy: Policy = F32, loss_mode: str = "multiscale",
            max_to_keep: int = 10, seed: int = 0,
            log_dir: str | None = None, panel_samples: int = 4,
            device="cuda") -> TrainState:
    """Step-driven training loop (model_pwcnet.py:587-788 parity: periodic
    display/val, BestCheckpointSaver-style top-k retention ranked by EPE).

    log_dir: when set, writes TensorBoard events: train loss / val EPE
    scalars, plus an img1|img2|flow_pred|warped|flow_gt panel of the first
    `panel_samples` val samples every val round (the reference's
    OptFlowTBLogger.log_imgs_w_flows observability, logger.py:132-177).
    """
    schedule_fn = schedule_fn or sched.multisteps(
        [1e-4, 5e-5, 2.5e-5, 1.25e-5, 6.25e-6, 3.125e-6],
        [400000, 600000, 800000, 1000000, 1200000])
    # tf.train.AdamOptimizer(lr, epsilon=1e-8) parity: the reference's
    # non-mixed-precision path (model_pwcnet.py:266-270)
    state = create_pwc_state(seed, tf_adam(schedule_fn), cfg, device)
    dev = device_of(state.model)
    step_fn = make_pwc_train_step(cfg, policy, loss_mode)
    eval_fn = make_pwc_eval_step(cfg, policy)
    mgr = CheckpointManager(ckpt_dir, max_to_keep=max_to_keep, best_mode="min")
    tb = TBLogger(log_dir) if log_dir else None

    @torch.no_grad()
    def log_val_panel(model, step):
        """One flow-panel image summary from the first val batch."""
        vb = next(iter(dataset.batches(batch_size, train=False)), None)
        if vb is None:
            return
        n = min(panel_samples, len(vb["x"]))
        x = torch.as_tensor(vb["x"][:n]).to(dev)
        flow_pred, _ = pwcnet.apply(model, x[:, 0], x[:, 1], cfg, policy)
        warped = dense_image_warp(x[:, 1], flow_pred.float())
        panel = flow_panels(np.asarray(vb["x"][:n]), flow_pred.float().cpu().numpy(),
                            warped.float().cpu().numpy(), np.asarray(vb["y"][:n]))
        tb.log_image("val/flow_panel", panel, step)

    def epochs():
        for ep in itertools.count():
            yield from dataset.batches(batch_size, train=True, epoch_seed=seed + ep)

    t0 = time.time()
    # f32 without TF32 under an f32 policy (fisr_tpu_torch/device.py)
    with f32_scope(policy):
        try:
            for i, batch in enumerate(prefetch_to_device(epochs(), dev)):
                if i >= steps:
                    break
                state, m = step_fn(state, batch)
                if i % display_every == 0:
                    loss = float(m["loss"])
                    print(f"step {i}/{steps} loss {loss:.4f} "
                          f"({(time.time() - t0) / 60:.1f} min)", flush=True)
                    if tb:
                        tb.log_scalar("train/loss", loss, i)
                if (i + 1) % val_every == 0 or i + 1 == steps:
                    # sample-weighted mean: batches() yields a final partial batch
                    # so every val sample counts exactly once
                    vals = [(float(eval_fn(state.model, vb)["epe"]), len(vb["x"]))
                            for vb in dataset.batches(batch_size, train=False)]
                    n_val = sum(n for _, n in vals)
                    val_epe = (sum(e * n for e, n in vals) / n_val) if n_val else None
                    print(f"step {i + 1}: val EPE "
                          f"{'n/a (empty val split)' if val_epe is None else f'{val_epe:.4f}'}",
                          flush=True)
                    if tb and val_epe is not None:
                        tb.log_scalar("val/EPE", val_epe, i + 1)
                        log_val_panel(state.model, i + 1)
                    mgr.save(state.step, train_state_tree(state.model, state.optimizer, state.step),
                             metric=val_epe)
        finally:
            if tb:
                tb.close()
    return state
