"""Epoch-level training loop: console format, checkpoints and metrics log
(port of fisr_tpu/train/loop.py).

Drives train/trainer the way FISRnet.train() drives its session loop
(FISRnet.py:580-744): per-epoch shuffle, periodic console status, epoch
averages, per-epoch validation, per-epoch checkpoint keyed on the global
step, and resume that derives (epoch, batch) from the restored step. Metrics
go to a JSONL file per experiment and to TensorBoard event files
(utils/tb_writer, no TF needed).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from fisr_tpu_torch.convert.params import load_train_state_, train_state_tree
from fisr_tpu_torch.core.mesh import barrier, data_sharding, mesh_device, replicated
from fisr_tpu_torch.data.dataset import TrainStore
from fisr_tpu_torch.device import f32_scope, resolve_device
from fisr_tpu_torch.ops.conv import F32, Policy
from fisr_tpu_torch.ops.seq import groups_to_overlap, split_seq_dim
from fisr_tpu_torch.train import schedule as sched
from fisr_tpu_torch.train.checkpoint import CheckpointManager, derive_epoch_batch
from fisr_tpu_torch.train.losses import LossWeights
from fisr_tpu_torch.train.trainer import (TrainState, batch_to_device, create_state,
                                          device_of, forward_windows, make_train_step,
                                          make_val_step, tf_adam)
from fisr_tpu_torch.utils import profiling
from fisr_tpu_torch.utils.tb_writer import TBLogger
from fisr_tpu_torch.utils.watchdog import Heartbeat

__all__ = ["fit", "train_epoch", "prefetch_to_device", "build_schedule", "read_metrics"]


def prefetch_to_device(batch_iter, device, size: int = 2, sharding=None):
    """Host-to-device batch prefetch, one batch ahead of the consumer.

    On a CUDA device each numpy batch is staged in pinned host memory and
    copied with `non_blocking=True`, so the NEXT batch's copy is queued
    before the current step is consumed and overlaps its compute. On the CPU
    it is a plain iterator over tensors. `sharding`, as in the JAX package a
    function of an array's ndim (lambda nd: core.mesh.data_sharding(mesh,
    nd)), cuts each global batch to this rank's rows before the copy.
    """
    device = torch.device(device)

    def local(b):
        if sharding is None:
            return b
        return {k: np.ascontiguousarray(sharding(np.ndim(v))(v)) for k, v in b.items()}

    if device.type != "cuda":
        for b in batch_iter:
            yield {k: torch.as_tensor(v) for k, v in local(b).items()}
        return

    def put(b):
        return {k: torch.as_tensor(v).pin_memory().to(device, non_blocking=True)
                for k, v in local(b).items()}

    q = collections.deque()
    for b in batch_iter:
        q.append(put(b))
        if len(q) >= size:
            yield q.popleft()
    while q:
        yield q.popleft()


def build_schedule(lr_type: str, init_lr: float, iters_per_epoch: int,
                   epochs: int, stair_points, stair_factor: float,
                   linear_decay_point: int):
    if lr_type == "stair_decay":
        bounds = [p * iters_per_epoch for p in stair_points]
        return sched.stair_decay(init_lr, bounds, stair_factor)
    if lr_type == "linear_decay":
        return sched.linear_decay(init_lr, epochs, linear_decay_point,
                                  iters_per_epoch)
    return sched.no_decay(init_lr)


def read_metrics(metrics: dict) -> dict:
    """A step's metrics (0-dim tensors on one device) as Python floats, in
    ONE read-back: the values `float(v)` would give one by one, for one wait
    on the device instead of one per metric."""
    values = torch.stack([v.float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


def train_epoch(state: TrainState, step_fn, batches, *, start: int = 0, epoch: int = 0,
                iters: int = 0, freq_display: int = 100, t_start: float = 0.0,
                writer: bool = True, hb: Optional[Heartbeat] = None):
    """`fit`'s body over one epoch's batches: each batch's step, its metrics
    read back in one wait on the device (the span `train.metrics_read`),
    added to the epoch's sums, a heartbeat, and every `freq_display`-th
    batch (counted from `start`) the console line when `writer`.
    Returns (state, {metric: sum over the batches}, batches run)."""
    sums, count = {}, 0
    for idx, batch in enumerate(batches, start=start):
        state, m = step_fn(state, batch)
        count += 1
        with profiling.span("train.metrics_read"):
            m = read_metrics(m)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v
        if hb is not None:
            hb.beat()  # after the read-back = real device progress
        if writer and idx % freq_display == 0:
            print(f"Epoch: [{epoch:3d}], [{idx:4d}/{iters:4d}], "
                  f"time: {(time.time() - t_start) / 60:4.2f}(min), "
                  f"train_PSNR: {m['train_PSNR']:.3f}, "
                  f"total_loss: {m['total_loss']:.6f}", flush=True)
    return state, sums, count


def fit(
    store: TrainStore,
    ckpt_dir: str,
    log_dir: Optional[str] = None,
    epochs: int = 100,
    batch_size: int = 8,
    val_batch_size: int = 2,
    init_lr: float = 1e-4,
    lr_type: str = "stair_decay",
    lr_stair_decay_points=(80, 90),
    lr_decreasing_factor: float = 0.1,
    lr_linear_decay_point: int = 50,
    loss_weights: LossWeights = LossWeights(),
    freq_display: int = 100,
    policy: Policy = F32,
    seed: int = 0,
    resume: bool = True,
    step_timeout_s: Optional[float] = None,
    device="cuda",
    mesh=None,
) -> TrainState:
    """Train FISRnet (full width) on `store`; returns the final state.

    With a `mesh` (core/mesh) training is data-parallel over its 'data'
    axis, as the JAX `fit(mesh=)`: every rank draws the same global batch
    (the same epoch seed) and keeps its rows, the state is replicated from
    the axis's first rank at the start and after a resume, and the steps
    average gradients and metrics over the axis. The device is the mesh's.
    Only global rank 0 prints, writes checkpoints, metrics.jsonl and
    TensorBoard; the others wait at a barrier before a resume reads a step.
    Every rank runs the whole validation pass on its replica, so its numbers
    are those of a single-process `fit`.

    `step_timeout_s` arms a utils.watchdog.Heartbeat: if no train step /
    val batch completes within that window the process dumps all thread
    stacks and exits with status 86, so a supervisor restarts it and this
    same function resumes from the last per-epoch checkpoint. Size it to
    cover the first step (cuDNN picks its algorithms there) plus margin;
    None (default) disarms it."""
    dev = resolve_device(device) if mesh is None else mesh_device(mesh)
    writer = mesh is None or dist.get_rank() == 0
    iters = store.num_batches(batch_size)
    schedule_fn = build_schedule(lr_type, init_lr, iters, epochs,
                                 lr_stair_decay_points, lr_decreasing_factor,
                                 lr_linear_decay_point)
    state = create_state(seed, tf_adam(schedule_fn), device=dev)
    step_fn = make_train_step(loss_weights, policy, mesh=mesh)
    val_fn = make_val_step(policy)

    mgr = CheckpointManager(ckpt_dir, max_to_keep=1)
    start_epoch = 0
    start_batch = 0
    if mesh is not None:
        barrier(mesh)  # rank 0's last checkpoint is on disk before any rank reads
    if resume and mgr.latest_step() is not None:
        state.step = load_train_state_(state.model, state.optimizer, mgr.restore())
        start_epoch, start_batch = derive_epoch_batch(state.step, iters)
        if writer:
            print(f" [*] resumed from step {state.step} "
                  f"(epoch {start_epoch}, batch {start_batch})")
    batch_sharding = None
    if mesh is not None:
        replicated(mesh, state.model, state.optimizer)
        batch_sharding = lambda nd: data_sharding(mesh, nd)  # noqa: E731

    metrics_path = None
    tb = None
    if log_dir and writer:
        os.makedirs(log_dir, exist_ok=True)
        metrics_path = os.path.join(log_dir, "metrics.jsonl")
        tb = TBLogger(log_dir)

    hb = (Heartbeat(step_timeout_s, name="fit").start()
          if step_timeout_s else None)
    t_start = time.time()
    # f32 without TF32 under an f32 policy (fisr_tpu_torch/device.py)
    with f32_scope(policy):
        # finally: even an escaping exception (out of memory, a bad batch) must
        # disarm the watchdog, or the armed monitor os._exit(86)s a process that
        # is no longer hung and masks the real error
        try:
            for epoch in range(start_epoch, epochs):
                batches = store.batches(batch_size, epoch_seed=seed + epoch)
                # mid-epoch resume (FISRnet.py:596-606): the epoch permutation is
                # epoch-seeded, so skipping the first `start_batch` draws continues
                # the interrupted epoch on exactly the batches it had left
                skip = start_batch if epoch == start_epoch else 0
                if skip:
                    batches = itertools.islice(batches, skip, None)
                batches = prefetch_to_device(batches, dev, sharding=batch_sharding)
                state, sums, count = train_epoch(
                    state, step_fn, batches, start=skip, epoch=epoch, iters=iters,
                    freq_display=freq_display, t_start=t_start, writer=writer, hb=hb)
                epoch_means = {k: v / max(count, 1) for k, v in sums.items()}

                val_sums, val_count = {}, 0
                for vb in store.val_batches(val_batch_size):
                    vm = read_metrics(val_fn(state.model, vb))
                    val_count += 1
                    for k, v in vm.items():
                        val_sums[k] = val_sums.get(k, 0.0) + v
                    if hb is not None:
                        hb.beat()
                val_means = {k: v / max(val_count, 1) for k, v in val_sums.items()}
                if not writer:
                    continue
                print(f"######### Validation epoch [{epoch}/{epochs}]: "
                      f"val_PSNR {val_means.get('val_PSNR', float('nan')):.3f} dB, "
                      f"recnLoss {val_means.get('val_recnLoss', float('nan')):.6f} #########",
                      flush=True)

                if metrics_path:
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps({"epoch": epoch, "step": state.step,
                                            **epoch_means, **val_means}) + "\n")
                if tb is not None:
                    tb.log_scalars({**epoch_means, **val_means}, state.step)
                    _log_val_images(tb, store, state, policy)
                mgr.save(state.step, train_state_tree(state.model, state.optimizer, state.step),
                         metric=val_means.get("val_recnLoss"))
        finally:
            if hb is not None:
                hb.stop()
            if tb is not None:
                tb.close()
    return state


@torch.no_grad()
def _log_val_images(tb: TBLogger, store: TrainStore, state: TrainState, policy: Policy) -> None:
    """Image summaries (YUV, like FISRnet.py:555-565): the middle frame of the
    first validation sample's merged prediction, and its ground truth."""
    vb = next(store.val_batches(1), None)
    if vb is None:
        return
    vb = batch_to_device(vb, device_of(state.model))
    groups, _ = forward_windows(state.model, vb, policy, with_ss2=False)
    pred = groups_to_overlap(groups[0])[0, 3]
    gt = split_seq_dim(vb["label"])[0, 3]
    for tag, img in (("Seq3_Pred", pred), ("Seq3_GT", gt)):
        tb.log_image(tag, np.uint8(np.clip(img.float().cpu().numpy(), 0, 1) * 255), state.step)
