"""FISRnet training engine (port of fisr_tpu/train/trainer.py).

Replaces the reference's feed_dict train loop (FISRnet.py:580-744). The
reference builds 4 weight-shared forward graphs per step (3 stride-1 window
replicas + 1 stride-2, :281-306/:403-406) and a separate val graph; here ONE
forward apply runs over [4B] batch rows (windows and the stride-2 input are
folded into the batch axis: identical math, one set of larger convolutions)
and the rows are split again for the loss terms.

The JAX package keeps (params, opt_state, step) in a pytree and returns a
new one from a jitted step. Here the state is a module, its optimizer and an
integer step; a step updates them in place, eagerly, or on a card as one
replayed CUDA graph (`_StepGraph`, shared with the PWC-Net trainer).

Optimizer parity: `TFAdam` is tf.train.AdamOptimizer (FISRnet.py:489-491),
which is NOT `torch.optim.Adam`: see the class.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import weakref
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from fisr_tpu_torch.core.mesh import average_gradients_, mean_metrics
from fisr_tpu_torch.models import fisrnet
from fisr_tpu_torch.ops.conv import F32, Policy
from fisr_tpu_torch.ops.metrics import psnr_image
from fisr_tpu_torch.ops.resize import downsample_int
from fisr_tpu_torch.ops.seq import groups_to_overlap, split_seq_dim, stack_windows
from fisr_tpu_torch.train.losses import LossWeights, l2_loss, temporal_loss
from fisr_tpu_torch.utils import profiling

Batch = Dict[str, torch.Tensor]
LearningRate = Union[float, Callable[[int], float]]

__all__ = ["TFAdam", "TrainState", "tf_adam", "create_state",
           "make_train_step", "make_val_step", "forward_windows", "batch_to_device",
           "device_of"]


class TFAdam(torch.optim.Optimizer):
    """Adam with tf.train.AdamOptimizer semantics (FISRnet.py:489-491,
    model_pwcnet.py:266-270), the JAX package's `tf_adam`.

    TF1 applies  lr * sqrt(1-b2^t)/(1-b1^t) * m_t / (sqrt(v_t) + eps):
    eps is added to the UNcorrected sqrt(v), so the effective eps on the
    bias-corrected quotient is eps*sqrt(1-b2^t), 31.6x smaller than
    `torch.optim.Adam`'s at t=1 and converging to eps as t grows. Negligible
    for well-scaled gradients (|g| >> eps), visible on near-zero-gradient
    leaves; tests/fixtures/tf_oracle/optimizer.npz pins this form against the
    reference's own AdamOptimizer.

    State: `count` (steps taken, one for the optimizer) and per parameter
    `mu` and `nu`, the fields of the JAX package's ScaleByAdamState
    (convert/params.py carries them across). `learning_rate` is a float or a
    schedule over the PRE-increment step count, TF's evaluation order of an
    lr tensor on global_step. b1^t, b2^t and the correction are float32, as
    TF's beta-power accumulators are. A parameter without a gradient takes a
    zero gradient (its moments decay), as a leaf outside the loss does under
    `jax.grad`.

    A step is two halves. `begin_step` runs on the host: it evaluates the
    schedule, advances `count` and writes the learning rate and each group's
    correction into 0-dim float32 tensors on the parameters' device
    (`fill_`, which passes the value as a kernel argument). `update` is the
    device's work and reads both from there, so an update captured in a CUDA
    graph (train/pwc_trainer) replays with each step's values; `step` is
    the two in turn, and eager and replayed steps run the same arithmetic.
    """

    def __init__(self, params, learning_rate: LearningRate, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps))
        self.learning_rate = learning_rate
        self.count = 0
        # per group: (learning rate, bias correction), on the group's device
        self._scalars = []
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
            dev = group["params"][0].device
            self._scalars.append(tuple(torch.zeros((), dtype=torch.float32, device=dev)
                                       for _ in range(2)))

    def current_lr(self) -> float:
        """The learning rate the next step will use."""
        lr = self.learning_rate
        return float(lr(self.count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def begin_step(self) -> None:
        """The host's half of a step: this step's learning rate and bias
        corrections into the device scalars that `update` reads."""
        lr = self.current_lr()
        self.count += 1
        t = np.float32(self.count)
        for group, (lr_t, corr_t) in zip(self.param_groups, self._scalars):
            b1, b2 = np.float32(group["b1"]), np.float32(group["b2"])
            corr = np.sqrt(np.float32(1.0) - b2 ** t) / (np.float32(1.0) - b1 ** t)
            lr_t.fill_(lr)
            corr_t.fill_(float(corr))

    @torch.no_grad()
    def update(self) -> None:
        """The device's half of a step: the moments and parameters updated in
        place from the gradients and the scalars `begin_step` wrote."""
        for group, (lr_t, corr_t) in zip(self.param_groups, self._scalars):
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            params = list(group["params"])
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            denom = torch._foreach_sqrt(nu)
            torch._foreach_add_(denom, eps)
            scaled = torch._foreach_mul(mu, corr_t)
            torch._foreach_div_(scaled, denom)
            torch._foreach_mul_(scaled, lr_t)
            torch._foreach_sub_(params, scaled)

    def step(self, closure=None):
        if closure is not None:
            raise ValueError("TFAdam.step takes no closure")
        self.begin_step()
        self.update()


def tf_adam(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8) -> Callable[..., TFAdam]:
    """tf.train.AdamOptimizer(lr) as an optimizer factory: call the result on
    a model's parameters (create_state does) to get its TFAdam."""
    return functools.partial(TFAdam, learning_rate=learning_rate, b1=b1, b2=b2, eps=eps)


@dataclasses.dataclass
class TrainState:
    """A module, the optimizer over its parameters, and the global step."""

    model: nn.Module
    optimizer: TFAdam
    step: int = 0


def create_state(seed: int, optimizer: Callable[..., TFAdam], in_ch: int = fisrnet.IN_CH,
                 ch: int = fisrnet.BASE_CH, device="cuda") -> TrainState:
    """ch: model width; 64 is the reference model, narrow widths serve tests.
    `optimizer` is a factory over parameters (tf_adam)."""
    model = fisrnet.FISRnet(in_ch=in_ch, ch=ch, seed=seed, device=device)
    return TrainState(model, optimizer(model.parameters()), 0)


def batch_to_device(batch, device) -> Batch:
    """A batch of numpy arrays or tensors as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def device_of(model: nn.Module) -> torch.device:
    """The device a model's parameters live on (all on one)."""
    return next(model.parameters()).device


def _ss2_input(data: torch.Tensor, flow_ss2: torch.Tensor, warp_ss2: torch.Tensor):
    """Stride-2 window: frames {0, 2, 4} of the merged 5-frame input
    (FISRnet.py:394-399)."""
    frames = torch.cat([data[..., 0:3], data[..., 6:9], data[..., 12:15]], dim=-1)
    return torch.cat([frames, flow_ss2, warp_ss2], dim=-1)


def forward_windows(model: fisrnet.FISRnet, batch: Batch, policy: Policy = F32,
                    with_ss2: bool = True):
    """One model apply over all window rows.

    batch keys: data [B,H,W,15], flow [B,H,W,16], warp [B,H,W,24], and (if
    with_ss2) flow_ss2 [B,H,W,8], warp_ss2 [B,H,W,12].
    Returns (pred_groups, pred_ss2): 3-tuples over scales (l3, l2, l1) of
    [B, 9, ...] / [B, 3, ...] 5-dim predictions (pred_ss2 None w/o ss2).
    """
    b = batch["data"].shape[0]
    rows = stack_windows(batch["data"], batch["flow"], batch["warp"])  # [3B,...]
    n_rows = 3
    if with_ss2:
        rows = torch.cat(
            [rows, _ss2_input(batch["data"], batch["flow_ss2"], batch["warp_ss2"])], 0)
        n_rows = 4

    preds = fisrnet.apply(model, rows, model.sf, policy)  # (l1, l2, l3)
    groups, ss2 = [], []
    for scale in (2, 1, 0):  # reorder to (l3, l2, l1)
        p5 = split_seq_dim(preds[scale])  # [n_rows*B, 3, h, w, 3]
        wins = [p5[i * b : (i + 1) * b] for i in range(n_rows)]
        groups.append(torch.cat(wins[:3], dim=1))  # [B, 9, ...]
        if with_ss2:
            ss2.append(wins[3])  # [B, 3, ...]
    return tuple(groups), (tuple(ss2) if with_ss2 else None)


def _gt_pyramid(label: torch.Tensor):
    """label: merged [B, 2H, 2W, 21] -> 5-dim GT at (l3, l2, l1).

    The reference builds the GT pyramid with TF1 bicubic /2 and /4
    (FISRnet.py:263-264), which for integer factors is subsampling.
    """
    return (
        split_seq_dim(label),
        split_seq_dim(downsample_int(label, 2)),
        split_seq_dim(downsample_int(label, 4)),
    )


class _StepGraph:
    """A training step as one CUDA graph, after torch.cuda.graphs' recipe for
    a whole network: eager warm-up calls on a side stream, the gradients set
    to None before the capture so that the backward makes them in the
    graph's memory pool, then one replay a step.

    The graph is bound to what its capture baked in: the model and optimizer
    themselves (held by weak reference and compared with `is`, so a new
    state never passes for a freed one whose memory it reuses), the address
    of every tensor the replay reads or writes outside its pool (parameters,
    moments, the optimizer's device scalars), the batch's shapes and dtypes,
    and the numeric flags that choose cuDNN's and cuBLAS's kernels; the
    configuration and policy belong to the step function that owns this
    object. A call under anything else drops the graph and runs eagerly, and
    the third call in a row under the same binding captures anew.

    `forward_backward(model, batch)` returns the step's metrics, a dict of
    detached tensors; a replay returns copies of them, so each keeps its
    step's values. A replay copies the batch into the graph's input tensors,
    writes the optimizer's learning rate and corrections
    (`TFAdam.begin_step`) and launches the graph, all on the current stream. Before enqueuing a step
    the host waits for the step two before it (a ring of blocking events),
    so it runs at most two steps ahead of the card and sleeps, instead of
    spinning, while it waits."""

    CAPTURE_AT = 3  # the call, under one binding, that captures
    AHEAD = 2  # steps the host may enqueue before the card has finished them

    def __init__(self, forward_backward, eager):
        self.forward_backward, self.eager = forward_backward, eager
        self.owner, self.key, self.calls = None, None, 0
        self.graph = self.inputs = self.out = None
        self.done, self.n = None, 0

    @staticmethod
    def _key(state: TrainState, batch) -> tuple:
        model, opt = state.model, state.optimizer
        baked = [*model.parameters(),
                 *(opt.state[p][f] for g in opt.param_groups for p in g["params"]
                   for f in ("mu", "nu")),
                 *itertools.chain.from_iterable(opt._scalars)]
        return (tuple(t.data_ptr() for t in baked),
                tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(batch.items())),
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)

    def _bind(self, state: TrainState, batch) -> bool:
        """Whether the calls so far were under this state and batch's binding;
        if not, the graph is dropped and this binding starts anew."""
        key = self._key(state, batch)
        if (self.owner is not None and self.owner[0]() is state.model
                and self.owner[1]() is state.optimizer and key == self.key):
            return True
        self._drop()
        self.owner = (weakref.ref(state.model), weakref.ref(state.optimizer))
        self.key, self.calls = key, 0
        return False

    def _drop(self) -> None:
        for ev in self.done or ():
            ev.synchronize()  # no replay of the graph is left in flight
        self.graph = self.inputs = self.out = None

    def _warm_up(self, state: TrainState, batch) -> Dict:
        here = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(here)
        with torch.cuda.stream(side):
            metrics = self.eager(state, batch)
        here.wait_stream(side)
        return metrics

    def _capture(self, state: TrainState, batch) -> None:
        model, opt = state.model, state.optimizer
        self.inputs = {k: torch.empty_like(v) for k, v in batch.items()}
        opt.zero_grad(set_to_none=True)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            self.out = self.forward_backward(model, self.inputs)
            opt.update()
        self.graph = g
        profiling.count("train.graph_captures")

    def __call__(self, state: TrainState, batch) -> Dict:
        self._bind(state, batch)
        self.calls += 1
        if self.graph is None and self.calls < self.CAPTURE_AT:
            return self._warm_up(state, batch)
        if self.done is None:
            self.done = [torch.cuda.Event(blocking=True) for _ in range(self.AHEAD)]
        ring = self.done[self.n % self.AHEAD]
        ring.synchronize()  # the step AHEAD before this one has finished
        if self.graph is None:
            self._capture(state, batch)
        for k, v in batch.items():
            self.inputs[k].copy_(v)
        state.optimizer.begin_step()
        self.graph.replay()
        metrics = {k: v.clone() for k, v in self.out.items()}
        ring.record()
        self.n += 1
        profiling.count("train.graph_replays")
        return metrics


def make_train_step(
    loss_weights: LossWeights = LossWeights(),
    policy: Policy = F32,
    mesh=None,
    graph: bool = True,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step(state, batch) -> (state, metrics): forward over the 4B window
    rows, the temporal loss, backward, one TFAdam update in place. The batch
    may hold numpy arrays or tensors anywhere; it is moved to the model's
    device. Metrics are 0-dim f32 tensors on that device (the ten loss terms
    and train_PSNR), detached.

    With a `mesh` (core/mesh) the step is data-parallel over its 'data'
    axis, the port's form of the JAX step on a sharded batch: `batch` holds
    this rank's rows (core/mesh.shard_batch), the gradients are averaged
    over the axis before the update and the metrics are the axes' means,
    i.e. the global batch's values (every term is a mean over the batch).

    On a CUDA model without a mesh the step is one CUDA graph (`_StepGraph`,
    as pwc_trainer.make_pwc_train_step's): the first two calls run eagerly,
    the third captures forward, loss, backward and the TFAdam update, and
    later calls with the same state and batch shapes replay it. `graph=False`
    keeps every call eager. Each call counts one `train.fisr_steps`
    (utils/profiling)."""

    def forward_backward(model, batch) -> Dict[str, torch.Tensor]:
        pred_groups, pred_ss2 = forward_windows(model, batch, policy)
        gt = _gt_pyramid(batch["label"])
        total, metrics = temporal_loss(pred_groups, pred_ss2, gt, loss_weights)
        with torch.no_grad():  # reported, not optimised
            ovlp = groups_to_overlap(pred_groups[0])
            metrics["train_PSNR"] = torch.mean(psnr_image(ovlp, gt[0]))
        total.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def eager(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        metrics = forward_backward(model, batch)
        if mesh is not None:
            average_gradients_(model.parameters(), mesh)
            metrics = mean_metrics(metrics, mesh)
        opt.step()
        return metrics

    graphed = _StepGraph(forward_backward, eager) if graph and mesh is None else None

    def step_fn(state: TrainState, batch: Batch):
        dev = device_of(state.model)
        batch = batch_to_device(batch, dev)
        if graphed is not None and dev.type == "cuda":
            metrics = graphed(state, batch)
        else:
            metrics = eager(state, batch)
        state.step += 1
        profiling.count("train.fisr_steps")
        return state, metrics

    return step_fn


def make_val_step(policy: Policy = F32):
    """Validation: stride-1 windows only, recn-L2 + PSNR on the merged
    sequence (FISRnet.py:493-533). fn(model, batch) -> metrics."""

    @torch.no_grad()
    def val_fn(model: fisrnet.FISRnet, batch: Batch):
        batch = batch_to_device(batch, device_of(model))
        pred_groups, _ = forward_windows(model, batch, policy, with_ss2=False)
        gt = split_seq_dim(batch["label"]).float()
        ovlp = groups_to_overlap(pred_groups[0]).float()
        return {
            "val_recnLoss": l2_loss(ovlp, gt),
            "val_PSNR": torch.mean(psnr_image(ovlp, gt)),
        }

    return val_fn
