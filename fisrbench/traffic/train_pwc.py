"""PWC-Net training traffic: the body of `pwc_fit`'s loop.

Set-up makes the weights on the card from the seed, `samples` FlyingChairs-
sized pairs with their flows (harness/scene.flow_pairs), the port's
`FlowDataset` over them with random crops and the default augmentation, and
the training state (`TFAdam` on pwc_fit's multisteps schedule). It then
drives the window's own feed, `prefetch_to_device(dataset.batches(...))`,
and step, `make_pwc_train_step`, through the first three steps, reading
each step's loss, the first gradient from the optimizer's first moment and
the parameters' change after the third. The window goes on with the same
objects, reading the loss back every 100 steps as pwc_fit does; no
validation or checkpoint. A traced run traces the window's first
`trace_steps` steps.

After the window the float32 reference (reference/train.py) follows the
first three steps from the same weights, working the batches out again from
the same raw pairs and flows.

`control` puts the reference, at a lower precision, in the program's place
(harness/controls.py); `tiny` cuts a cell to a CPU test's size.
"""

from __future__ import annotations

import gc
import itertools
import math
import sys
import time

import numpy as np
import torch

from fisrbench.harness import scene, work
from fisrbench.harness.runner import Outcome, RunContext, Window, cpu_seconds, load_into, \
    peak_bytes, seeded_params, sync
from fisrbench.harness.trace import Spans, traced
from fisrbench.reference import train as ref_train
from fisrbench.reference.ops import Numerics
from fisrbench.reference.pwcnet import param_shapes as pwc_shapes

FIRST = 3  # steps the reference follows
CV_LAUNCHES_PER_STEP = 5  # forward, and backward, each: one launch a pyramid level

TINY = dict(samples=12, sample_hw=[80, 96], crop_hw=[64, 64], batch=2, max_flow_px=3.0,
            trace_steps=1)


def tiny(config: dict, mix: dict):
    """The cell cut to a CPU test's size: small pairs, crops and batch."""
    return config, dict(mix, **TINY)


def make_data(ctx: RunContext):
    """(pairs u8 [n, 2, h, w, 3], flows f32 [n, h, w, 2]) on the host."""
    mix = ctx.mix
    h, w = mix["sample_hw"]
    pairs, flows = scene.flow_pairs(ctx.generator(3), mix["samples"], h, w, mix["max_flow_px"],
                                    ctx.device)
    return pairs.cpu().numpy(), flows.cpu().numpy()


def seeds(ctx: RunContext):
    """(the data layer's augmentation seed, the first epoch's seed)."""
    r = ctx.rng(6)
    return int(r.integers(0, 2**62)), int(r.integers(0, 2**62))


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def run(ctx: RunContext) -> Outcome:
    from fisr_tpu_torch.data.augment import AugmentOptions
    from fisr_tpu_torch.data.flow_dataset import FlowDataset
    from fisr_tpu_torch.device import f32_scope
    from fisr_tpu_torch.models import pwcnet
    from fisr_tpu_torch.ops.conv import BF16, F32
    from fisr_tpu_torch.train import schedule as sched
    from fisr_tpu_torch.train.loop import prefetch_to_device
    from fisr_tpu_torch.train.pwc_trainer import make_pwc_train_step
    from fisr_tpu_torch.train.trainer import TFAdam, TrainState

    cfg, mix = ctx.config, ctx.mix
    pc, opt_cfg = cfg["pwcnet"], cfg["optimizer"]
    policy = {"bfloat16": BF16, "float32": F32}[cfg["compute_dtype"]]
    params0 = seeded_params(pwc_shapes(**pc), ctx.generator(1), ctx.device)
    model = pwcnet.PWCNet(pwcnet.PWCNetConfig(**pc), seed=0, device=ctx.device)
    load_into(model, params0)
    schedule = sched.multisteps(opt_cfg["lr_values"], opt_cfg["boundaries"])
    state = TrainState(model, TFAdam(model.parameters(), schedule, b1=opt_cfg["b1"],
                                     b2=opt_cfg["b2"], eps=opt_cfg["eps"]), 0)
    pairs, flows = make_data(ctx)
    data_seed, epoch_seed = seeds(ctx)
    dataset = FlowDataset(pairs, flows, crop_hw=tuple(mix["crop_hw"]),
                          aug=AugmentOptions(**cfg["augment"]), seed=data_seed)
    step_fn = make_pwc_train_step(None, policy, cfg["loss"]["mode"], gamma=cfg["loss"]["gamma"])
    batch = mix["batch"]

    def epochs():
        for ep in itertools.count():
            yield from dataset.batches(batch, train=True, epoch_seed=epoch_seed + ep)

    names = [n for n, _p in model.named_parameters()]
    spans = Spans()
    with f32_scope(policy):
        feed = prefetch_to_device(epochs(), ctx.device)
        losses, grad0 = [], None
        for i in range(FIRST):
            state, m = step_fn(state, next(feed))
            losses.append(float(m["loss"]))
            if i == 0:
                b1 = state.optimizer.param_groups[0]["b1"]
                grad0 = leaf_norms({n: state.optimizer.state[p]["mu"] / (1.0 - b1)
                                    for n, p in model.named_parameters()})
        delta = leaf_norms({n: p.detach() - params0[n] for n, p in model.named_parameters()})
        sync(ctx.device)
        setup_s = time.perf_counter() - ctx.t_start

        steps, nonfinite = 0, 0
        cpu_mark, m, b, tr = None, None, None, None
        window = Window(ctx.seconds, ctx.device).open()
        if ctx.trace:
            def traced_steps():
                nonlocal state, m, b, steps
                for _ in range(mix["trace_steps"]):
                    with spans.span("next(feed)"):
                        b = next(feed)
                    with spans.span("train step"):
                        state, m = step_fn(state, b)
                    steps += 1

            n_cv = CV_LAUNCHES_PER_STEP * mix["trace_steps"]
            tr = traced(traced_steps, spans, {"cost_volume_kernel": n_cv, "cost_volume_bwd": n_cv})
            cpu_mark, steps_traced = cpu_seconds(), steps
        while not window.done():
            with spans.span("next(feed)"):
                b = next(feed)
            with spans.span("train step"):
                state, m = step_fn(state, b)
            steps += 1
            if (FIRST + steps) % 100 == 0:
                nonfinite += not math.isfinite(float(m["loss"]))
        elapsed = window.close()
        cpu_end = cpu_seconds()
    feed.close()
    split = {}
    for name, a, z in spans.items:
        split[name] = split.get(name, 0.0) + (z - a) * 1e-9
    print(f"train: {steps} steps of {batch} in {elapsed:.3f} s; host clock in the window's "
          f"calls: {split}", file=sys.stderr)

    peak = peak_bytes(ctx.device)
    reading = {}
    if ctx.trace:
        reading = _reading(ctx, tr, steps_traced,
                           cpu_end - cpu_mark if steps > steps_traced else None,
                           steps - steps_traced)
    del state, model, m, b, feed
    gc.collect()
    torch.cuda.empty_cache()

    checks = check(ctx, pairs, flows, params0, names, losses, grad0, delta,
                   schedule(0), data_seed, epoch_seed)
    return Outcome(setup_s=setup_s, e2e={"train_sps": steps * batch / elapsed},
                   attempted=steps, failed=nonfinite, checks=checks,
                   memory_peak_bytes=peak, reading=reading)


def _reading(ctx, tr, steps_traced, cpu_s, steps_untraced) -> dict:
    cfg, mix = ctx.config, ctx.mix
    ch, cw = mix["crop_hw"]
    dtype = cfg["compute_dtype"]
    levels = work.pwc_level_shapes(mix["batch"], ch, cw, cfg["pwcnet"])
    return {
        "trace": tr,
        "units": {"steps": steps_traced},
        "cpu_s": cpu_s,
        "cpu_units": {"steps": steps_untraced} if cpu_s is not None else None,
        # forward and backward: three times the forward's FLOPs
        "flops": {"steps": 3 * work.pwc_flops(mix["batch"], ch, cw, cfg["pwcnet"])},
        "peak_flops": work.PEAK_FLOPS[dtype],
        "cv_fwd": {"kernel": "cost_volume_kernel", "launches_per_cycle": len(levels),
                   "bound_s_per_cycle": sum(work.cv_bound_s(s, dtype) for s in levels)},
        "cv_bwd": {"kernel": "cost_volume_bwd", "launches_per_cycle": len(levels),
                   "bound_s_per_cycle": sum(work.cv_bwd_bound_s(s, dtype) for s in levels)},
    }


def reference_readings(ctx, pairs, flows, params0, data_seed, epoch_seed, lr,
                       numerics: str = "exact"):
    """The reference's (losses, first-gradient norms, change norms) over the
    first three steps, computed at `numerics` (reference/ops.Numerics)."""
    cfg, mix = ctx.config, ctx.mix
    nx = Numerics(numerics)
    batches = ref_train.training_batches(pairs, flows, tuple(mix["crop_hw"]), cfg["augment"],
                                         data_seed, epoch_seed, mix["batch"], FIRST)
    batches = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches]
    params = {k: v.detach().clone() for k, v in params0.items()}
    with nx.backend():
        losses, g0 = ref_train.train_steps(params, cfg["pwcnet"], batches, lr,
                                           cfg["loss"]["gamma"], nx)
    return (losses, leaf_norms(g0),
            leaf_norms({k: params[k] - params0[k] for k in params}))


def gaps(ref, got, names, worst=None):
    """(loss gap, gradient gap, change gap, leaves left out).

    The loss gap is the relative gap of each step's loss (worst step). A
    leaf's gap is the gap of its norm against the larger of its reference
    norm and the median leaf's, over the leaves whose reference gradient is
    at least a thousandth of the median leaf's. The change gap is the worst
    leaf's; the gradient gap is the median leaf's, since the worst leaf's
    first gradient is one small bias whose sum cancels (PERF.md). `worst`,
    a dict, gets the worst leaf and its gap of each."""
    losses_r, g_r, d_r = ref
    losses_p, g_p, d_p = got
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r))
    med_g = float(np.median([g_r[n] for n in names]))
    keep = [n for n in names if g_r[n] >= 1e-3 * med_g]
    med_d = float(np.median([d_r[n] for n in keep]))
    grad = {n: abs(g_p[n] - g_r[n]) / max(g_r[n], med_g) for n in keep}
    change = {n: abs(d_p[n] - d_r[n]) / max(d_r[n], med_d) for n in keep}
    if worst is not None:
        wg, wc = max(grad, key=grad.get), max(change, key=change.get)
        worst.update(grad=(wg, grad[wg]), change=(wc, change[wc]))
    return (loss, float(np.median(list(grad.values()))), max(change.values()),
            [n for n in names if n not in keep])


def check(ctx, pairs, flows, params0, names, losses, grad0, delta, lr, data_seed, epoch_seed):
    t0 = time.perf_counter()
    ref = reference_readings(ctx, pairs, flows, params0, data_seed, epoch_seed, lr)
    worst = {}
    loss, grad, change, out = gaps(ref, (losses, grad0, delta), names, worst)
    print(f"train: losses {losses} (reference {ref[0]}); worst leaves {worst}; "
          f"left out by the gradient rule: {out}; reference check "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    lim = ctx.mix["limits"]
    return [("loss_rel_gap", loss, lim["loss_rel_gap"]),
            ("grad_gap_median_leaf", grad, lim["grad_gap_median_leaf"]),
            ("change_norm_gap", change, lim["change_norm_gap"])]


def control(ctx, numerics: str):
    """`check` of the reference at `numerics` in the program's place: its
    losses, first gradient and change over the first three steps, from the
    weights, pairs and seeds that a run draws."""
    cfg = ctx.config
    params0 = seeded_params(pwc_shapes(**cfg["pwcnet"]), ctx.generator(1), ctx.device)
    pairs, flows = make_data(ctx)
    data_seed, epoch_seed = seeds(ctx)
    lr = cfg["optimizer"]["lr_values"][0]
    losses, grad0, delta = reference_readings(ctx, pairs, flows, params0, data_seed,
                                              epoch_seed, lr, numerics)
    return check(ctx, pairs, flows, params0, sorted(params0), losses, grad0, delta, lr,
                 data_seed, epoch_seed), 0
