"""Port: the host runtime's fused flow-sample pass (native.flow_sample,
csrc/native.cc) against the numpy path it replaces in FlowDataset: crop,
data/augment.apply_plan and / 255. Every comparison is bit for bit
(np.array_equal), on u8 pairs and f32 flows with exact zeros in them."""

import numpy as np
import pytest

from fisr_tpu_torch import native
from fisr_tpu_torch.data.augment import AugmentOptions, AugmentPlan, augment_pair, plan_augment
from fisr_tpu_torch.data.flow_dataset import FlowDataset
from fisr_tpu_torch.utils import profiling

H, W = 40, 52
PLAIN = native.plain_versions()["flow_sample"]


def _source(seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    pair = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    flow = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    flow[: h // 3, : w // 4] = 0.0  # zeros: the flips' signs and the shift's add
    return pair, flow


def _both(pair, flow, corner, crop, plan):
    ch, cw = crop
    got = (np.full((2, ch, cw, 3), np.nan, np.float32), np.full((ch, cw, 2), np.nan, np.float32))
    want = (np.empty_like(got[0]), np.empty_like(got[1]))
    native.flow_sample(pair, flow, corner, crop, plan, *got)
    PLAIN(pair, flow, corner, crop, plan, *want)
    return got, want


def _equal(got, want):
    return all(np.array_equal(a, b) for a, b in zip(got, want))


PLANS = {
    "none": None,
    "identity": AugmentPlan(),
    "fliplr": AugmentPlan(fliplr=True),
    "flipud": AugmentPlan(flipud=True),
    "both_flips": AugmentPlan(fliplr=True, flipud=True),
    "shift_pos": AugmentPlan(shift=(3, 2)),
    "shift_neg": AugmentPlan(shift=(-2, -3)),
    "shift_x_only": AugmentPlan(shift=(-4, 0)),
    "shift_y_only": AugmentPlan(shift=(0, 5)),
    "shift_mixed": AugmentPlan(shift=(2, -1)),
    "shift_wider_than_crop": AugmentPlan(shift=(40, -31)),
    "scale_0.95": AugmentPlan(ratio=0.95),
    "scale_0.97": AugmentPlan(ratio=0.97),
    "scale_1.0": AugmentPlan(ratio=1.0),
    "scale_1.03": AugmentPlan(ratio=1.03),
    "scale_1.05": AugmentPlan(ratio=1.05),
    "all_up": AugmentPlan(fliplr=True, flipud=True, shift=(-3, 2), ratio=1.047),
    "all_down": AugmentPlan(fliplr=True, flipud=True, shift=(2, -3), ratio=0.953),
    "lr_shift_scale": AugmentPlan(fliplr=True, shift=(1, 1), ratio=0.9),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_forced_plan_is_bit_equal_to_numpy(name):
    pair, flow = _source(1)
    got, want = _both(pair, flow, (5, 3), (31, 45), PLANS[name])
    assert _equal(got, want)


@pytest.mark.parametrize("corner", ["top_left", "top_right", "bottom_left", "bottom_right"])
@pytest.mark.parametrize("crop", [(17, 23), (33, 51), (40, 52)])
def test_odd_crops_at_the_corners_are_bit_equal(corner, crop):
    pair, flow = _source(2)
    ch, cw = crop
    y0 = 0 if corner.startswith("top") else H - ch
    x0 = 0 if corner.endswith("left") else W - cw
    for plan in (None, PLANS["all_up"], PLANS["all_down"]):
        got, want = _both(pair, flow, (y0, x0), crop, plan)
        assert _equal(got, want)


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_drawn_plans_are_bit_equal_to_augment_pair(seed):
    """Plans drawn as the dataset draws them, wide options, against the
    plain augment_pair on the crop with the same generator."""
    pair, flow = _source(seed)
    opts = AugmentOptions(translate_frac=0.2, scale_frac=0.1)
    for k in range(6):
        plan = plan_augment(opts, np.random.default_rng([seed, k]), 29, 37)
        got, want = _both(pair, flow, (k, 2 * k), (29, 37), plan)
        x = pair.astype(np.float32)[:, k:k + 29, 2 * k:2 * k + 37]
        ax, ay = augment_pair(x, flow[k:k + 29, 2 * k:2 * k + 37], opts,
                              np.random.default_rng([seed, k]))
        assert _equal(got, want) and _equal(got, (ax / 255.0, ay))


def _numpy_batches(pairs, flows, crop, aug, seed, batch, epoch_seed, train, n_val):
    """FlowDataset's numpy batches: per sample the crop draws, augment_pair
    and / 255, then np.stack; the generator it ran on."""
    rng = np.random.default_rng(seed)
    n = len(pairs)
    idxs = np.arange(n - n_val) if train else np.arange(n - n_val, n)
    if train:
        idxs = np.random.default_rng(epoch_seed).permutation(idxs)
    out = []
    ch, cw = crop
    h, w = flows.shape[1:3]
    for s in range(0, len(idxs) - batch + 1 if train else len(idxs), batch):
        xs, ys = [], []
        for j in idxs[s:s + batch]:
            x, y = pairs[j].astype(np.float32), flows[j]
            y0 = rng.integers(0, h - ch + 1) if train else (h - ch) // 2
            x0 = rng.integers(0, w - cw + 1) if train else (w - cw) // 2
            x, y = x[:, y0:y0 + ch, x0:x0 + cw], y[y0:y0 + ch, x0:x0 + cw]
            if train:
                x, y = augment_pair(x, y, aug, rng)
            xs.append(x / 255.0)
            ys.append(y)
        out.append({"x": np.stack(xs).astype(np.float32), "y": np.stack(ys).astype(np.float32)})
    return out, rng


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("workers", [0, 2])
def test_dataset_batches_and_generator_equal_the_numpy_path(train, workers):
    n, n_val = 14, 4
    rng = np.random.default_rng(3)
    pairs = rng.integers(0, 256, (n, 2, 30, 34, 3), dtype=np.uint8)
    flows = rng.normal(0, 2, (n, 30, 34, 2)).astype(np.float32)
    aug = AugmentOptions(translate_frac=0.15, scale_frac=0.08)
    ds = FlowDataset(pairs, flows, split_sizes=(n - n_val, n_val), crop_hw=(21, 27), aug=aug,
                     seed=77)
    got = list(ds.batches(3, train=train, epoch_seed=4, num_workers=workers))
    want, rng_after = _numpy_batches(pairs, flows, (21, 27), aug, 77, 3, 4, train, n_val)
    assert len(got) == len(want) == (3 if train else 2)
    for a, b in zip(got, want):
        assert a["x"].dtype == a["y"].dtype == np.float32
        assert _equal((a["x"], a["y"]), (b["x"], b["y"]))
    assert ds._rng.bit_generator.state == rng_after.bit_generator.state


def test_uncropped_dataset_equals_the_numpy_path():
    pairs, flows = (np.stack([a, a[::-1].copy()]) for a in _source(4, 24, 28))
    ds = FlowDataset(pairs, flows, split_sizes=(2, 0), aug=AugmentOptions(), seed=8)
    got = list(ds.batches(2, train=True, epoch_seed=1))
    rng = np.random.default_rng(8)
    order = np.random.default_rng(1).permutation(2)
    for k, j in enumerate(order):
        x, y = augment_pair(pairs[j].astype(np.float32), flows[j], AugmentOptions(), rng)
        assert _equal((got[0]["x"][k], got[0]["y"][k]), (x / 255.0, y))
    assert ds._rng.bit_generator.state == rng.bit_generator.state


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_fused_counter_counts_every_sample_yielded(train):
    ds = FlowDataset.synthetic_textured(n=10, h=24, w=24, seed=2, crop_hw=(16, 16),
                                        aug=AugmentOptions(), val_split=0.3)
    before = profiling.totals()["counters"].get("data.fused", 0)
    got = list(ds.batches(3, train=train, epoch_seed=1))
    after = profiling.totals()["counters"]["data.fused"]
    assert after - before == sum(len(b["x"]) for b in got) == (6 if train else 3)


@pytest.mark.parametrize("case", ["pair_dtype", "pair_shape", "flow_shape", "flow_dtype",
                                  "crop_outside", "negative_corner", "out_shape", "out_dtype",
                                  "out_strided"])
def test_bad_arguments_raise(case):
    pair, flow = _source(0)
    x = np.empty((2, 8, 8, 3), np.float32)
    y = np.empty((8, 8, 2), np.float32)
    args = dict(pair=pair, flow=flow, corner=(0, 0), crop_hw=(8, 8), plan=None, x_out=x,
                y_out=y)
    args.update({
        "pair_dtype": dict(pair=pair.astype(np.float32)),
        "pair_shape": dict(pair=pair[:1]),
        "flow_shape": dict(flow=flow[1:]),
        "flow_dtype": dict(flow=flow.astype(np.float64)),
        "crop_outside": dict(corner=(H - 7, 0)),
        "negative_corner": dict(corner=(0, -1)),
        "out_shape": dict(y_out=np.empty((8, 9, 2), np.float32)),
        "out_dtype": dict(x_out=x.astype(np.float64)),
        "out_strided": dict(x_out=np.empty((2, 8, 16, 3), np.float32)[:, :, ::2]),
    }[case])
    with pytest.raises(ValueError):
        native.flow_sample(**args)


def test_concurrent_callers_share_the_pool():
    """Threads more than the host's cores calling the pass at once (ctypes
    drops the GIL): each result still bit-equal to its plain version."""
    import sys
    import threading

    pair, flow = _source(6)
    plans = list(PLANS.values())
    want = [_both(pair, flow, (4, 2), (31, 45), p)[1] for p in plans]
    bad, done = [], []

    def worker(k):
        for i in range(12):
            plan = (k + i) % len(plans)
            got = _both(pair, flow, (4, 2), (31, 45), plans[plan])[0]
            if not _equal(got, want[plan]):
                bad.append((k, i))
        done.append(k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(12)) and not bad


def _fork_child(q):
    pair, flow = _source(7)
    got, want = _both(pair, flow, (1, 1), (30, 40), PLANS["all_up"])
    q.put(_equal(got, want))


def test_a_forked_child_starts_its_own_pool():
    """The pool's threads are not inherited by a forked child: the child's
    first call starts a pool of its own instead of waiting on none."""
    import multiprocessing

    pair, flow = _source(7)
    assert _equal(*_both(pair, flow, (1, 1), (30, 40), PLANS["all_up"]))  # the parent's pool
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    child = ctx.Process(target=_fork_child, args=(q,))
    child.start()
    try:
        ok = q.get(timeout=60)
    finally:
        child.join(timeout=30)
        if child.is_alive():
            child.kill()
    assert ok is True and child.exitcode == 0
