"""Port: FISRnet training as the benchmark's `fisr-train-96-bf16` cell runs
it, on the CPU. The program's train step against the benchmark's plain
float32 reference (fisrbench/reference/fisr_train.py), the loop body that
`fit` and the benchmark share, the step's and the store's spans and
counters, their readers, and the cell's driver at a tiny size: sound, and
with each planted fault (FAULTS, also what the cell's limits were set
against on the card, PERF.md section 2).

Tolerances of the step against the reference (ch=8, 2 samples of 32x32, 3
steps, f32 on one CPU): each of the ten loss metrics within rtol 1e-5 (the
two compute the same sums in other orders: f32 rounding of a mean over
~10^4 entries, measured 0 to 1e-7); each leaf's first-gradient norm and its
parameter change after three steps within 1e-4 of the larger of its own and
the median leaf's reference norm (the leaf rule of traffic/train_pwc.gaps:
a leaf's summed gradient may cancel to a small norm whose rounding is
relative to the terms summed, not to the sum; Adam's first updates are
about sign(g) * lr, so an entry whose gradient lies in rounding noise can
move by 2 lr; measured below 1e-6).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from fisrbench.harness.manifest import Manifest
from fisrbench.harness.runner import load_into, seeded_params
from fisrbench.reference import fisr_train as ref
from fisrbench.reference.fisrnet import param_shapes
from fisrbench.traffic import train_fisr
from fisrbench.tests.tiny import tiny_ctx
from fisrbench.traffic.train_pwc import gaps, leaf_norms
from fisr_tpu_torch.data import synth
from fisr_tpu_torch.data.dataset import TrainStore
from fisr_tpu_torch.models import fisrnet
from fisr_tpu_torch.ops.conv import F32
from fisr_tpu_torch.ops.seq import split_seq_dim
from fisr_tpu_torch.train import loop, trainer
from fisr_tpu_torch.train.losses import LossWeights
from fisr_tpu_torch.utils import profiling

CELL = "fisr-train-96-bf16"
LAMBDAS = dict(recn=1.0, tm1=1.0, tm2=0.1, tmm=1.0, td=0.1, ss2=1.0)


# ---- planted faults, each in the program's place ----------------------------------

# term -> (the subtotal it belongs to, its lambda)
SUBTOTAL = {"recnLoss": ("totalLoss_s1", "recn"), "tmLoss": ("totalLoss_s1", "tm1"),
            "tmmLoss": ("totalLoss_s1", "tmm"), "tdLoss": ("totalLoss_s1", "td"),
            "recnLoss_ss2": ("totalLoss_ss2", "recn"), "tdLoss_ss2": ("totalLoss_ss2", "td"),
            "tmLoss_ss2": ("totalLoss_ss2", "tm2")}


def _term_left_out(term: str):
    """The temporal loss with `term` not added to its subtotal and the total
    (the step backpropagates that total); the term itself is still reported."""
    def plant(mp):
        real = trainer.temporal_loss

        def loss(pred_groups, pred_ss2, gt, weights=LossWeights()):
            total, m = real(pred_groups, pred_ss2, gt, weights)
            sub, lam = SUBTOTAL[term]
            part = getattr(weights, lam) * m[term]
            outer = 1.0 if sub == "totalLoss_s1" else weights.ss2
            m = dict(m, **{sub: m[sub] - part, "total_loss": total - outer * part})
            return m["total_loss"], m

        mp.setattr(trainer, "temporal_loss", loss)
    return plant


def _ss2_row_dropped(mp):
    """The stride-2 row left out of the model's batch: its terms read the
    middle stride-1 window's prediction instead."""
    real = trainer.forward_windows

    def forward(model, batch, policy=F32, with_ss2=True):
        groups, _ = real(model, batch, policy, with_ss2=False)
        return groups, (tuple(g[:, 3:6] for g in groups) if with_ss2 else None)

    mp.setattr(trainer, "forward_windows", forward)


def _gt_averaged(mp):
    """The ground-truth pyramid by 2x2 (and 4x4) averaging instead of TF1's
    bicubic, which is subsampling."""
    def pyramid(label):
        x = label.permute(0, 3, 1, 2)
        down = [torch.nn.functional.avg_pool2d(x, f).permute(0, 2, 3, 1) for f in (2, 4)]
        return split_seq_dim(label), split_seq_dim(down[0]), split_seq_dim(down[1])

    mp.setattr(trainer, "_gt_pyramid", pyramid)


def _half_batch(mp):
    """Each step on the first half of its batch."""
    real = trainer.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def fn(state, batch):
            n = len(batch["data"]) // 2
            return step(state, {key: v[:n] for key, v in batch.items()})
        return fn

    mp.setattr(trainer, "make_train_step", make)


FAULTS = {**{f"left_out_{t}": _term_left_out(t) for t in SUBTOTAL},
          "ss2_row_dropped": _ss2_row_dropped, "gt_averaged": _gt_averaged,
          "half_batch": _half_batch}


# ---- the step against the reference ------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """A seeded ch=8 FISRnet's weights and 3 batches of 2 samples of 32x32
    from the port's synthetic store."""
    params = seeded_params(param_shapes(29, 8, 2), torch.Generator().manual_seed(5), "cpu")
    store = synth.synthetic_store(n_samples=8, h=32, w=32, seed=1, val_size=2)
    batches = list(itertools.islice(store.batches(2, epoch_seed=3), 3))
    return params, batches


def test_train_step_matches_the_plain_reference(small):
    params0, batches = small
    model = fisrnet.FISRnet(in_ch=29, ch=8, seed=0, device="cpu")
    load_into(model, params0)
    state = trainer.TrainState(model, trainer.tf_adam(1e-4)(model.parameters()))
    step = trainer.make_train_step(LossWeights(**LAMBDAS), F32)
    got, grad0 = [], None
    for i, b in enumerate(batches):
        state, m = step(state, b)
        got.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grad0 = leaf_norms({n: state.optimizer.state[p]["mu"] / 0.1
                                for n, p in model.named_parameters()})
    delta = leaf_norms({n: p.detach() - params0[n] for n, p in model.named_parameters()})
    params = {k: v.clone() for k, v in params0.items()}
    want, g0 = ref.train_steps(params, 2, [{k: torch.from_numpy(v) for k, v in b.items()}
                                           for b in batches], 1e-4, LAMBDAS)
    for n in range(3):
        for k in ref.TERMS:
            assert got[n][k] == pytest.approx(want[n][k], rel=1e-5), (n, k)
    d_r = leaf_norms({k: params[k] - params0[k] for k in params})
    names = sorted(params0)
    _loss, grad, change, out = gaps(([w["total_loss"] for w in want], leaf_norms(g0), d_r),
                                    ([g["total_loss"] for g in got], grad0, delta), names)
    assert out == []
    # every leaf, not the median: the gradient gap's worst leaf too
    med = float(np.median([leaf_norms(g0)[n] for n in names]))
    worst = max(abs(grad0[n] - leaf_norms(g0)[n]) / max(leaf_norms(g0)[n], med) for n in names)
    assert worst <= 1e-4 and change <= 1e-4 and grad <= 1e-4


def test_reference_gt_pyramid_is_tf1_bicubic_subsampling():
    """TF1's legacy bicubic at an integer factor samples whole pixels, where
    the Keys taps are (0, 1, 0, 0): the port's bicubic tables say so too."""
    from fisr_tpu_torch.ops.resize import resize_tf1

    label = torch.rand(1, 16, 16, 21)
    for f, got in zip((1, 2, 4), ref.gt_pyramid(label)):
        want = resize_tf1(label, (16 // f, 16 // f), "bicubic") if f > 1 else label
        assert torch.allclose(got, split_seq_dim(want), rtol=0, atol=1e-6)


def test_reference_rows_are_the_ports_window_rows(small):
    _params, batches = small
    b = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    from fisr_tpu_torch.ops.seq import stack_windows

    rows = torch.cat([stack_windows(b["data"], b["flow"], b["warp"]),
                      trainer._ss2_input(b["data"], b["flow_ss2"], b["warp_ss2"])])
    assert torch.equal(ref.window_rows(b), rows)


# ---- fit's loop body, spans and counters ---------------------------------------------

def test_fit_runs_its_epochs_through_train_epoch(tmp_path, monkeypatch):
    store = synth.synthetic_store(n_samples=6, h=32, w=32, seed=0, val_size=2)
    calls = []
    real = loop.train_epoch

    def spy(state, step_fn, batches, **kw):
        out = real(state, step_fn, batches, **kw)
        calls.append((kw["epoch"], kw["start"], out[2]))
        return out

    monkeypatch.setattr(loop, "train_epoch", spy)
    state = loop.fit(store, ckpt_dir=str(tmp_path / "ck"), epochs=2, batch_size=2,
                     lr_type="no_decay", device="cpu")
    assert calls == [(0, 0, 2), (1, 0, 2)] and state.step == 4


def test_train_epoch_sums_reads_and_displays(capsys):
    seen = []

    def step(state, batch):
        seen.append(batch)
        return state + 1, {"total_loss": torch.tensor(float(batch)),
                           "train_PSNR": torch.tensor(2.0)}

    before = profiling.totals()["spans"].get("train.metrics_read", (0, 0.0))[0]
    state, sums, n = loop.train_epoch(0, step, iter([1, 2, 3]), start=4, epoch=7, iters=9,
                                      freq_display=5, writer=True)
    assert (state, n, seen) == (3, 3, [1, 2, 3])
    assert sums == {"total_loss": 6.0, "train_PSNR": 6.0}
    assert profiling.totals()["spans"]["train.metrics_read"][0] - before == 3
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("Epoch: [  7], [   5/   9], time: ")
    assert out[0].endswith("train_PSNR: 2.000, total_loss: 2.000000")
    loop.train_epoch(0, step, iter([1]), writer=False)
    assert capsys.readouterr().out == ""


def _delta(before, after, kind, name):
    get = (lambda t: t[kind].get(name, (0, 0.0))[0]) if kind == "spans" else \
        (lambda t: t[kind].get(name, 0))
    return get(after) - get(before)


def test_a_step_and_a_batch_record_their_spans_and_counters(small):
    params0, _batches = small
    store = synth.synthetic_store(n_samples=6, h=32, w=32, seed=0, val_size=2)
    model = fisrnet.FISRnet(in_ch=29, ch=8, seed=0, device="cpu")
    state = trainer.TrainState(model, trainer.tf_adam(1e-4)(model.parameters()))
    before = profiling.totals()
    batches = store.batches(2, epoch_seed=0)
    batch = next(batches)
    mid = profiling.totals()
    loop.train_epoch(state, trainer.make_train_step(), iter([batch]), writer=False)
    after = profiling.totals()
    assert _delta(before, mid, "spans", "data.store_batch") == 1
    assert _delta(before, mid, "counters", "data.store_batches") == 1
    for kind, name in (("counters", "train.fisr_steps"), ("spans", "train.metrics_read")):
        assert _delta(mid, after, kind, name) == 1, name
    assert _delta(before, after, "counters", "train.steps") == 0  # PWC-Net's, not read here


GRAPH_COUNTERS = ("train.fisr_steps", "train.graph_captures", "train.graph_replays")


def _graph_counters() -> dict:
    c = profiling.totals()["counters"]
    return {k: c.get(k, 0) for k in GRAPH_COUNTERS}


def _fisr_run(device, policy, batches, params0, graph: bool):
    """(each step's metrics as read after it, its metric tensors, the final
    state) of a ch=8 FISRnet from `params0` over `batches`."""
    model = fisrnet.FISRnet(in_ch=29, ch=8, seed=0, device=device)
    load_into(model, {k: v.to(device) for k, v in params0.items()})
    state = trainer.TrainState(model, trainer.tf_adam(1e-4)(model.parameters()))
    step = trainer.make_train_step(LossWeights(**LAMBDAS), policy, graph=graph)
    read, kept = [], []
    for b in batches:
        state, m = step(state, b)
        read.append({k: float(v) for k, v in m.items()})
        kept.append(m)
    return read, kept, state


def test_the_fisr_step_stays_eager_on_the_cpu(small):
    params0, batches = small
    before = _graph_counters()
    _fisr_run("cpu", F32, batches, params0, graph=True)
    now = _graph_counters()
    assert {k: now[k] - before[k] for k in GRAPH_COUNTERS} == {
        "train.fisr_steps": 3, "train.graph_captures": 0, "train.graph_replays": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_graphed_fisr_steps_equal_eager_steps(policy):
    """Five steps (two eager, a capture, two replays) under deterministic
    cuDNN with TF32 off: every metric, parameter and moment bit-equal to the
    eager steps', and each step's metrics keep their values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fisr_tpu_torch.ops.conv import BF16

    pol = {"f32": F32, "bf16": BF16}[policy]
    params0 = seeded_params(param_shapes(29, 8, 2), torch.Generator().manual_seed(5), "cpu")
    store = synth.synthetic_store(n_samples=12, h=32, w=32, seed=1, val_size=2)
    batches = list(itertools.islice(store.batches(2, epoch_seed=3), 5))
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        want, _, eager = _fisr_run("cuda", pol, batches, params0, graph=False)
        before = _graph_counters()
        got, kept, graphed = _fisr_run("cuda", pol, batches, params0, graph=True)
        torch.cuda.synchronize()
    now = _graph_counters()
    assert {k: now[k] - before[k] for k in GRAPH_COUNTERS} == {
        "train.fisr_steps": 5, "train.graph_captures": 1, "train.graph_replays": 3}
    assert got == want
    assert [{k: float(v) for k, v in m.items()} for m in kept] == got
    assert graphed.step == eager.step == 5
    for (k, p), q in zip(graphed.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(p, q), k
        for field in ("mu", "nu"):
            assert torch.equal(graphed.optimizer.state[p][field],
                               eager.optimizer.state[q][field]), (k, field)


def test_host_split_sums_and_cuts_the_benchmarks_spans():
    ms = 1_000_000
    items = [("train step", 0, 80 * ms), ("next(feed)", 80 * ms, 90 * ms),
             ("train step", 90 * ms, 190 * ms), ("next(feed)", 190 * ms, 210 * ms),
             ("train step", 210 * ms, 300 * ms)]
    got = train_fisr.host_split(items)
    assert got["s"] == pytest.approx({"train step": 0.27, "next(feed)": 0.03}, rel=1e-12)
    # numpy's linear quantiles of (80, 100, 90) and of (10, 20) ms
    assert got["quantiles"] == {"train step": (82.0, 90.0, 98.0), "next(feed)": (11.0, 15.0, 19.0)}
    assert train_fisr.host_split([]) == {"s": {}, "quantiles": {}}


READING = {"cpu_s": 4.5, "cpu_units": {"steps": 50}, "host_s": {"next(feed)": 0.75,
                                                                  "train step": 4.0}}


@pytest.mark.parametrize("metric, want", [
    ("host_cpu_ms_per_step.fisr_train", 90.0),   # 4.5 s / 50 steps
    ("feed_ms_per_step.fisr_train", 15.0),       # 0.75 s / 50
    ("step_call_ms_per_step.fisr_train", 80.0),  # 4.0 s / 50
])
def test_the_cells_span_readers(metric, want):
    read = Manifest().reader(metric)
    assert read(READING) == pytest.approx(want, rel=1e-12)
    assert read(dict(READING, cpu_units={"steps": 0}, cpu_s=None, host_s=None)) is None
    assert read({"trace": {}}) is None  # a traced run with no untraced steps reads nothing


def test_the_train_cells_share_the_trace_metrics():
    m = Manifest()
    names = {x["name"] for x in m.per_layer(CELL)}
    assert {"device_busy_ms_per_step.train", "device_idle_pct.train", "kernels_per_step.train",
            "mfu.train"} <= names
    assert {x["source"] for x in m.per_layer(CELL)} <= {"device_trace", "host_clock"}


# ---- the cell's driver, tiny, on the CPU -----------------------------------------------

def test_the_cell_is_the_recipe():
    m = Manifest()
    cell = m.cell(CELL)
    cfg = m.config(cell["config"])
    assert cell["chips"] == 1 and m.mix(cell["traffic"])["driver"] == "train_fisr"
    assert cfg["loss"] == LAMBDAS and cfg["batch_size"] == 8 and cfg["patch"] == 96
    assert cfg["compute_dtype"] == "bfloat16" and cfg["fisrnet"] == {"in_ch": 29, "ch": 64, "sf": 2}
    assert {e["name"]: e for e in m.spec["configs"]}[cell["config"]]["reduced"] == \
        ["corpus_samples"]
    assert CELL in {e["name"]: e for e in m.spec["end_to_end"]}["train_sps"]["workloads"]
    assert len(m.per_layer(CELL)) == 7


def test_the_corpus_is_the_stores_contract():
    ctx = tiny_ctx(CELL)
    a = train_fisr.make_corpus(ctx)
    n, p = ctx.config["corpus_samples"], ctx.config["patch"]
    assert {k: v.shape for k, v in a.items()} == {
        "data": (n, p, p, 15), "label": (n, 2 * p, 2 * p, 21), "flow": (n, p, p, 16),
        "flow_ss2": (n, p, p, 8), "warp": (n, p, p, 24), "warp_ss2": (n, p, p, 12)}
    for k in ("data", "label", "warp", "warp_ss2"):
        assert 0.0 <= a[k].min() and a[k].max() <= 1.0, k
    # LR frames are every other label-side frame subsampled: LR 1 is HR 2, label frame 1
    assert np.array_equal(a["data"][..., 3:6], a["label"][:, ::2, ::2, 3:6])
    # uniform flows, forward and backward opposite, stride 2 twice stride 1
    f = a["flow"]
    assert np.ptp(f, axis=(1, 2)).max() == 0.0
    assert np.allclose(f[..., 0:2], -f[..., 2:4]) and np.allclose(a["flow_ss2"][..., 0:2],
                                                                   2 * f[..., 0:2])
    assert np.array_equal(train_fisr.make_corpus(ctx)["warp"], a["warp"])  # seeded


def test_the_warps_line_up_the_pan():
    """A middle-frame warp of the pan matches the HR frame between the pair
    better than either LR frame does (away from the moving discs)."""
    ctx = tiny_ctx(CELL)
    ctx.mix = dict(ctx.mix, objects=0, pan_px=[2.0, 2.0])
    a = train_fisr.make_corpus(ctx)
    mid = a["label"][:, ::2, ::2, 0:3][:, 4:-4, 4:-4]  # HR frame 1, subsampled
    warped = a["warp"][..., 0:3][:, 4:-4, 4:-4]
    lr0, lr1 = a["data"][..., 0:3][:, 4:-4, 4:-4], a["data"][..., 3:6][:, 4:-4, 4:-4]
    err = lambda x: float(np.abs(x - mid).mean())  # noqa: E731
    assert err(warped) < 0.5 * min(err(lr0), err(lr1))


def test_the_cells_tiny_run_is_correct():
    ctx = tiny_ctx(CELL, seconds=1.0)
    out = train_fisr.run(ctx)
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.failed == 0 and out.e2e["train_sps"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_the_cell(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = train_fisr.run(tiny_ctx(CELL))
    assert not out.correct, out.checks


def test_the_store_the_driver_builds_is_the_ports():
    ctx = tiny_ctx(CELL)
    a = train_fisr.make_corpus(ctx)
    store = TrainStore(**a, val_size=ctx.mix["val_samples"])
    want = train_fisr.first_batches(a, ctx.mix["val_samples"], 2, 11)
    got = list(itertools.islice(store.batches(2, epoch_seed=11), 3))
    for w, g in zip(want, got):
        assert all(np.array_equal(w[k].numpy(), g[k]) for k in train_fisr.KEYS)
