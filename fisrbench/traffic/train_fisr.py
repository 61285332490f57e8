"""FISRnet training traffic: the body of `fit`'s loop, as `--phase train`
runs it.

Set-up makes FISRnet's weights on the card from the configuration's
`weights_seed`, a corpus of `corpus_samples` training samples from --seed
(`make_corpus`: seeded 9-frame scenes, their LR stacks, known flows and
middle-frame warps), the port's `TrainStore` over it, `TFAdam` on the stair
schedule and `make_train_step` at the configuration's dtype. It then drives
`fit`'s own body, `train/loop.train_epoch`, fed by
`prefetch_to_device(store.batches(batch, epoch_seed + n))`, through the
first three steps one batch at a time, keeping each step's ten loss terms,
the first gradient (from the optimizer's first moment) and the parameters'
change after the third. The window goes on with the same objects through
the same function, epochs cycled; no validation or checkpoint, whose share
of a 504-sample epoch would be far above their share of the reference's
1,260-step epochs. A traced run traces the window's first `trace_steps`
steps.

After the window the float32 reference (reference/fisr_train.py) follows
the first three steps from the same weights on the same batches.

`control` puts the reference, at a lower precision, in the program's place
(harness/controls.py); `tiny` cuts the cell to a CPU test's size.
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
from fisrbench.harness.runner import Outcome, RunContext, Window, cpu_seconds, device_generator, \
    load_into, peak_bytes, seeded_params, sync
from fisrbench.harness.trace import Spans, traced
from fisrbench.reference import fisr_train as ref
from fisrbench.reference.fisrnet import param_shapes as fisr_shapes
from fisrbench.reference.ops import Numerics, rgb2yuv, warp, yuv2rgb
from fisrbench.traffic.train_pwc import gaps, leaf_norms

FIRST = 3  # steps the reference follows
KEYS = ("data", "label", "flow", "flow_ss2", "warp", "warp_ss2")

TINY_CONFIG = dict(corpus_samples=10, patch=32, batch_size=2)
TINY = dict(val_samples=2, pan_px=[0.5, 1.5], objects=1, obj_radius=[3, 8], obj_px=[0.5, 1.5],
            trace_steps=1)


def tiny(config: dict, mix: dict):
    """The cell cut to a CPU test's size: narrow FISRnet, float32 (the
    program's CPU path), 32x32 patches, batch 2, 8 training samples."""
    config = dict(config, fisrnet=dict(config["fisrnet"], ch=8), compute_dtype="float32",
                  **TINY_CONFIG)
    return config, dict(mix, **TINY)


def weights(ctx: RunContext) -> dict:
    """FISRnet's weights, drawn on the device from the configuration's
    `weights_seed` (a random network's loss and gradients vary with the
    draw, so the model is part of the configuration)."""
    fc = ctx.config["fisrnet"]
    return seeded_params(fisr_shapes(fc["in_ch"], fc["ch"], fc["sf"]),
                         device_generator(ctx.device, ctx.config["weights_seed"], 1), ctx.device)


def _merge(x):
    """[N, S, H, W, C] -> [N, H, W, S*C], frame s in channels [s*C, (s+1)*C)."""
    n, s, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(n, h, w, s * c)


def _pair_warps(lr, fwd):
    """Middle-frame warps of the pairs (k, k+1) of `lr` [K, F, h, w, 3] (YUV
    in [0, 255]) under the flows fwd [K, F-1, 2] (LR px, uniform) and -fwd:
    [K, 2(F-1), h, w, 3], per pair frame k+1 pulled back by half the forward
    flow, then frame k pulled forward by half the backward flow, in RGB."""
    k, f, h, w, _ = lr.shape
    out = []
    for i in range(f - 1):
        uv = fwd[:, i, None, None, :].expand(k, h, w, 2) * 0.5
        out.append(rgb2yuv(warp(yuv2rgb(lr[:, i + 1]), uv)))
        out.append(rgb2yuv(warp(yuv2rgb(lr[:, i]), -uv)))
    return torch.stack(out, dim=1)


def make_corpus(ctx: RunContext, chunk: int = 32) -> dict:
    """The six TrainStore arrays (float32 numpy, sequence merged into
    channels) of `corpus_samples` samples. A sample is a 9-frame scene of
    2P x 2P (harness/scene.clip: a textured pan at a speed drawn per sample,
    moving textured discs); its LR stack is every other frame subsampled 2x
    (5 frames of P x P), its label frames 1-7. The flows are the pan's known
    motion in LR px (frame k+1 shows frame k moved by -v: forward -v,
    backward +v; 2v at stride 2), normalised by /P/2 as
    TrainStore.from_files normalises them; the warps come from
    reference/ops.warp of the LR frames under those flows."""
    cfg, mix = ctx.config, ctx.mix
    n, p = cfg["corpus_samples"], cfg["patch"]
    gen = ctx.generator(3)
    pans = ctx.rng(4).uniform(*mix["pan_px"], n)
    shapes = {"data": 15, "label": 21, "flow": 16, "flow_ss2": 8, "warp": 24, "warp_ss2": 12}
    out = {k: np.empty((n, 2 * p if k == "label" else p, 2 * p if k == "label" else p, c),
                       np.float32) for k, c in shapes.items()}
    for lo in range(0, n, chunk):
        hr, vel = [], []
        for i in range(lo, min(n, lo + chunk)):
            probe = torch.Generator(device=ctx.device)
            probe.set_state(gen.get_state())  # clip's first draw is the pan's angle
            ang = float(torch.rand((1,), generator=probe, device=ctx.device)) * 2 * math.pi
            hr.append(scene.clip(gen, 9, 2 * p, 2 * p, float(pans[i]), mix["objects"],
                                 tuple(mix["obj_radius"]), tuple(mix["obj_px"]), ctx.device))
            # v HR px a frame over two frames at half the resolution: v LR px
            vel.append((float(pans[i]) * math.cos(ang), float(pans[i]) * math.sin(ang)))
        hr = torch.stack(hr).float()  # [K, 9, 2P, 2P, 3] YUV in [0, 255]
        v = torch.tensor(vel, dtype=torch.float32, device=ctx.device)  # [K, 2]
        lr = hr[:, 0::2, ::2, ::2]
        k = len(hr)
        fwd1 = (-v)[:, None].expand(k, 4, 2)
        fwd2 = (-2 * v)[:, None].expand(k, 2, 2)
        flow1 = torch.stack([fwd1, -fwd1], dim=2).reshape(k, 8, 1, 1, 2).expand(k, 8, p, p, 2)
        flow2 = torch.stack([fwd2, -fwd2], dim=2).reshape(k, 4, 1, 1, 2).expand(k, 4, p, p, 2)
        parts = {
            "data": lr / 255.0,
            "label": hr[:, 1:8] / 255.0,
            "flow": flow1 / p / 2.0,
            "flow_ss2": flow2 / p / 2.0,
            "warp": _pair_warps(lr, fwd1) / 255.0,
            "warp_ss2": _pair_warps(lr[:, 0::2], fwd2) / 255.0,
        }
        for key, x in parts.items():
            out[key][lo:lo + k] = _merge(x).cpu().numpy()
    return out


def seeds(ctx: RunContext) -> int:
    """The first epoch's seed."""
    return int(ctx.rng(6).integers(0, 2**62))


def first_batches(arrays: dict, val_samples: int, batch: int, epoch_seed: int):
    """The batches the first FIRST steps take, as tensors, worked out again
    in the data layer's documented order: the training split is the first
    n - val_samples samples, an epoch permutes it with numpy's
    default_rng(epoch_seed) and cuts batches in order."""
    n_train = len(arrays["data"]) - val_samples
    order = np.random.default_rng(epoch_seed).permutation(n_train)
    return [{k: torch.from_numpy(arrays[k][order[i * batch:(i + 1) * batch]]) for k in KEYS}
            for i in range(FIRST)]


def _policy(cfg: dict):
    from fisr_tpu_torch.ops.conv import BF16, F32

    return {"bfloat16": BF16, "float32": F32}[cfg["compute_dtype"]]


def start(ctx: RunContext, params0: dict, arrays: dict, spans: Spans):
    """The program set up as `fit` sets it up, over the corpus `arrays`, and
    its first FIRST steps through `fit`'s loop body, one batch at a time.
    Returns (state, step, feed, (each step's metrics, first gradients,
    change norms), the first step's learning rate); `step` and `feed` carry
    the benchmark's labels of the host's time (`spans`)."""
    from fisr_tpu_torch.data.dataset import TrainStore
    from fisr_tpu_torch.models import fisrnet
    from fisr_tpu_torch.train.loop import build_schedule, prefetch_to_device, train_epoch
    from fisr_tpu_torch.train.losses import LossWeights
    from fisr_tpu_torch.train.trainer import TFAdam, TrainState, make_train_step

    cfg, mix = ctx.config, ctx.mix
    fc, opt_cfg, batch = cfg["fisrnet"], cfg["optimizer"], cfg["batch_size"]
    model = fisrnet.FISRnet(in_ch=fc["in_ch"], sf=fc["sf"], ch=fc["ch"], seed=0, device=ctx.device)
    load_into(model, params0)
    store = TrainStore(**arrays, val_size=mix["val_samples"])
    # the last argument is linear decay's, unused by the stair schedule
    schedule = build_schedule("stair_decay", opt_cfg["init_lr"], store.num_batches(batch),
                              cfg["epochs"], opt_cfg["stair_epochs"], opt_cfg["stair_factor"], 0)
    state = TrainState(model, TFAdam(model.parameters(), schedule, b1=opt_cfg["b1"],
                                     b2=opt_cfg["b2"], eps=opt_cfg["eps"]), 0)
    step_fn = make_train_step(LossWeights(**cfg["loss"]), _policy(cfg))
    epoch_seed = seeds(ctx)

    def labelled(it):
        while True:
            with spans.span("next(feed)"):
                b = next(it)
            yield b

    def step(st, b):
        with spans.span("train step"):
            return step_fn(st, b)

    epochs = (b for ep in itertools.count()
              for b in store.batches(batch, epoch_seed=epoch_seed + ep))
    feed = labelled(prefetch_to_device(epochs, ctx.device))
    terms, grad0 = [], None
    for i in range(FIRST):
        state, sums, _n = train_epoch(state, step, itertools.islice(feed, 1), writer=False)
        terms.append(sums)
        if i == 0:
            b1 = state.optimizer.param_groups[0]["b1"]
            grad0 = {n: state.optimizer.state[p]["mu"] / (1.0 - b1)
                     for n, p in model.named_parameters()}
    delta = leaf_norms({n: p.detach() - params0[n] for n, p in model.named_parameters()})
    return state, step, feed, (terms, grad0, delta), schedule(0)


def run(ctx: RunContext) -> Outcome:
    from fisr_tpu_torch.device import f32_scope
    from fisr_tpu_torch.train.loop import train_epoch  # the parent of this cell has none

    cfg, mix = ctx.config, ctx.mix
    batch = cfg["batch_size"]
    params0 = weights(ctx)
    arrays = make_corpus(ctx)
    spans = Spans()
    with f32_scope(_policy(cfg)):
        state, step, feed, first, lr = start(ctx, params0, arrays, spans)
        sync(ctx.device)
        setup_s = time.perf_counter() - ctx.t_start

        steps, steps_traced, tr, seen = 0, 0, None, []
        window = Window(ctx.seconds, ctx.device).open()
        if ctx.trace:
            def traced_steps():
                nonlocal state, steps
                state, s, c = train_epoch(state, step, itertools.islice(feed, mix["trace_steps"]),
                                          writer=False)
                seen.append(s)
                steps += c

            # FISRnet's step launches no kernel of the port's own: nothing to expect
            tr = traced(traced_steps, spans, {})
            steps_traced = steps
        cpu_mark, mark = cpu_seconds(), len(spans.items)

        def until_done():
            for b in feed:
                yield b
                if window.done():
                    return

        state, s, c = train_epoch(state, step, until_done(), writer=False)
        seen.append(s)
        steps += c
        elapsed = window.close()
        cpu_s = cpu_seconds() - cpu_mark
    failed = 0 if all(math.isfinite(v) for s in seen for v in s.values()) else steps
    untraced = steps - steps_traced
    host = host_split(spans.items[mark:])
    starts = [a for name, a, _z in spans.items[mark:] if name == "train step"]
    quarters = np.histogram(starts, 4)[0].tolist() if starts else []
    print(f"train_fisr: {steps} steps of {batch} in {elapsed:.3f} s; untraced {untraced} (by "
          f"quarter of their time: {quarters}): host CPU {1e3 * cpu_s / max(untraced, 1):.1f} ms "
          f"a step; the benchmark's clock a step (p10 / p50 / p90 ms): {host['quantiles']}",
          file=sys.stderr)

    peak = peak_bytes(ctx.device)
    reading = _reading(ctx, tr, steps_traced, cpu_s, untraced, host["s"]) if ctx.trace else {}
    del state, step, feed
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    batches = first_batches(arrays, mix["val_samples"], batch, seeds(ctx))
    checks = check(ctx, reference_readings(ctx, params0, batches, lr), first, sorted(params0))
    return Outcome(setup_s=setup_s, e2e={"train_sps": steps * batch / elapsed},
                   attempted=steps, failed=failed, checks=checks,
                   memory_peak_bytes=peak, reading=reading)


def host_split(items) -> dict:
    """The benchmark's own host clock over its spans `items` (name, start
    ns, end ns): {"s": {name: summed seconds}, "quantiles": {name: (p10,
    p50, p90) of one span in ms}}."""
    by = {}
    for name, a, z in items:
        by.setdefault(name, []).append((z - a) * 1e-9)
    q = {k: tuple(round(1e3 * float(x), 2) for x in np.quantile(v, (0.1, 0.5, 0.9)))
         for k, v in by.items()}
    return {"s": {k: sum(v) for k, v in by.items()}, "quantiles": q}


def _reading(ctx, tr, steps_traced, cpu_s, steps_untraced, host_s) -> dict:
    cfg = ctx.config
    p = cfg["patch"]
    return {
        "trace": tr,
        "units": {"steps": steps_traced},
        # the untraced rest of the window: the process's CPU seconds and the
        # benchmark's clock around `next(feed)` and the step's call
        "cpu_s": cpu_s if steps_untraced else None,
        "cpu_units": {"steps": steps_untraced} if steps_untraced else None,
        "host_s": host_s if steps_untraced else None,
        # forward and backward: three times the forward's FLOPs, over the
        # four window rows of each sample
        "flops": {"steps": 3 * work.fisr_flops(4 * cfg["batch_size"], p, p, cfg["fisrnet"])},
        "peak_flops": work.PEAK_FLOPS[cfg["compute_dtype"]],
    }


def reference_readings(ctx, params0, batches, lr, numerics: str = "exact"):
    """The reference's (each step's {term: value}, first gradients, change
    norms) over the first steps, computed at `numerics`."""
    cfg = ctx.config
    nx = Numerics(numerics)
    params = {k: v.detach().clone() for k, v in params0.items()}
    with nx.backend():
        steps, g0 = ref.train_steps(params, cfg["fisrnet"]["sf"], batches, lr, cfg["loss"], nx)
    return (steps, g0, leaf_norms({k: params[k] - params0[k] for k in params}))


def input_gaps(g_r: dict, g_p: dict) -> dict:
    """{level.kind: gap} of the first gradient of each level's first
    convolution, cut by the kind of input channel it weighs (frames, flows,
    warps, the previous level's prediction): the norm of the program's
    difference from the reference over the reference's norm."""
    out = {}
    for name in ref.FIRST_CONVS:
        r, p = g_r[name].float(), g_p[name].float()
        for kind, sl in ref.INPUT_KINDS.items():
            if r[:, sl].numel():
                norm = torch.linalg.vector_norm
                out[f"{name.split('.')[0]}.{kind}"] = float(norm(p[:, sl] - r[:, sl])
                                                            / norm(r[:, sl]))
    return out


def check(ctx, reference, got, names):
    """[(name, value, limit)] of the program's first steps against the
    reference's: the worst step's relative gap of the total loss; the worst
    relative gap over the ten loss metrics at step 1; the leaf rule of
    traffic/train_pwc.gaps on first-gradient and change norms; the worst of
    `input_gaps`; and the worst step's relative gap of the program's total
    from the configuration's weighted sum of the program's own terms.

    The last two see what the others cannot (PERF.md section 2): which row
    fed which term (a random network's predictions of the four rows are
    nearly alike, but the stride-2 row's flows are twice the others', and
    the flows' gradients are too small a share of any leaf to move its
    norm), and a term of small weight left out of the total."""
    t0 = time.perf_counter()
    (ref_terms, G_r, d_r), (terms, G_p, d_p) = reference, got
    g_r, g_p = leaf_norms(G_r), leaf_norms(G_p)
    totals_r = [t["total_loss"] for t in ref_terms]
    totals_p = [t["total_loss"] for t in terms]
    worst = {}
    loss, grad, change, out = gaps((totals_r, g_r, d_r), (totals_p, g_p, d_p), names, worst)
    rel = {k: abs(terms[0][k] - ref_terms[0][k]) / abs(ref_terms[0][k]) for k in ref.TERMS}
    wt = max(rel, key=rel.get)
    inputs = input_gaps(G_r, G_p)
    wi = max(inputs, key=inputs.get)
    lam = ctx.config["loss"]
    composed = max(abs(t["total_loss"] - ref.compose(t, lam)["total_loss"]) / abs(t["total_loss"])
                   for t in terms)
    print(f"train_fisr: total_loss {totals_p} (reference {totals_r}); worst term {wt} "
          f"{rel[wt]:.3g}; worst leaves {worst}; left out by the gradient rule: {out}; worst "
          f"input {wi} {inputs[wi]:.3g}; {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    lim = ctx.mix["limits"]
    return [("loss_rel_gap", loss, lim["loss_rel_gap"]),
            ("term_rel_gap", rel[wt], lim["term_rel_gap"]),
            ("grad_gap_median_leaf", grad, lim["grad_gap_median_leaf"]),
            ("change_norm_gap", change, lim["change_norm_gap"]),
            ("input_grad_gap", inputs[wi], lim["input_grad_gap"]),
            ("total_composition_gap", composed, lim["total_composition_gap"])]


def control(ctx, numerics: str):
    """`check` of the reference at `numerics` in the program's place, from
    the weights, corpus and epoch seed that a run draws."""
    cfg = ctx.config
    params0 = weights(ctx)
    batches = first_batches(make_corpus(ctx), ctx.mix["val_samples"], cfg["batch_size"],
                            seeds(ctx))
    lr = cfg["optimizer"]["init_lr"]
    reference = reference_readings(ctx, params0, batches, lr)
    return check(ctx, reference, reference_readings(ctx, params0, batches, lr, numerics),
                 sorted(params0)), 0
