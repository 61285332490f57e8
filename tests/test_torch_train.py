"""Port: FISRnet training (schedules, the temporal loss, the train and
validation steps, TF-form Adam, the stores, checkpoints, fit and the CLI's
train phase) against the JAX package and the TF-oracle fixtures, f32, CPU.

Tolerances, with what was measured here:
* schedules: rtol 1e-6 at every step of a range that crosses each boundary
  (the JAX package evaluates them in f32 on the device, the port in Python
  floats on the host); the boundary steps hold the LEFT value.
* temporal_loss: rtol 1e-5 on each of the ten terms (measured 1.2e-7);
  forward_windows atol 1e-4 (measured 9.5e-7).
* three make_train_step steps at ch=8, 32x32, batch 2, on the oracle
  generator's damped weights: metrics rtol 2e-5 (measured 1.5e-6), every
  parameter after each step rtol 2e-5 / atol 1e-7 (measured 3.0e-8 absolute,
  0.04 of the bound, none of 765,699 entries outside it), Adam's moments
  within 1e-4 of each leaf's largest entry. With plain glorot weights the
  loss surface is rough enough that entries whose gradient lies inside the
  f32 noise of the two frameworks' summation orders come out up to 2*lr
  apart (Adam's first updates are about sign(g)*lr): 2, 690 and 786 entries
  after steps 1-3, which is why the damped weights are used. The JAX
  package's own data-parallel test bounds that effect by 2*lr an entry.
* TFAdam against the straight-line numpy TF Adam: rtol 2e-5, atol 1e-8.
* TF-oracle fixtures at full width, at the JAX tests' bounds: every loss
  term and train_PSNR 1e-5 relative, gradients 3e-5 of the leaf's largest +
  1e-9, val_recnLoss 1e-5, val_PSNR 1e-3, schedule.npz rtol 1e-6,
  optimizer.npz small leaves 0.1 of the largest delta and the delta digests
  2e-3 (three full-width steps take about 10 s on one thread, so they run in
  the fast lane).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fisr_tpu.data import synth as jsynth
from fisr_tpu.models import fisrnet as jfisr
from fisr_tpu.train import checkpoint as jcheckpoint
from fisr_tpu.train import losses as jlosses
from fisr_tpu.train import schedule as jschedule
from fisr_tpu.train import trainer as jtrainer
from fisr_tpu.utils import summary as jsummary
from fisr_tpu.utils import tb_writer as jtb
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.convert.oracle import deterministic_tf_vars, tf_vars_digest
from fisr_tpu_torch.data import synth
from fisr_tpu_torch.data.dataset import TrainStore
from fisr_tpu_torch.train import checkpoint, loop, losses, schedule, trainer
from fisr_tpu_torch.utils import summary, tb_writer
from fisr_tpu_torch.utils.watchdog import EXIT_CODE, Heartbeat

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "tf_oracle")
BATCH_KEYS = ("data", "label", "flow", "warp", "flow_ss2", "warp_ss2")
TERMS = ["recnLoss", "tmLoss", "tmmLoss", "tdLoss", "totalLoss_s1", "recnLoss_ss2",
         "tdLoss_ss2", "tmLoss_ss2", "totalLoss_ss2", "total_loss"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return dict(params.flatten_tree(tree))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---- schedules ---------------------------------------------------------------

SCHEDULES = {
    "stair_decay": (lambda m: m.stair_decay(1e-4, [8, 20], 0.1), 30),
    "linear_decay": (lambda m: m.linear_decay(1e-4, 10, 4, 3), 36),
    "no_decay": (lambda m: m.no_decay(3e-4), 5),
    "multisteps": (lambda m: m.multisteps([1e-4, 5e-5, 2.5e-5], [7, 15]), 25),
    "cyclic": (lambda m: m.cyclic(1e-5, 5e-4, 6), 40),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_at_every_step(name):
    make, n = SCHEDULES[name]
    ours, theirs = make(schedule), make(jschedule)
    got = [ours(s) for s in range(n)]
    want = [float(theirs(jnp.asarray(s))) for s in range(n)]
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_schedules_match_tf_oracle():
    with open(os.path.join(FIX, "schedule_manifest.json")) as f:
        man = json.load(f)
    z = np.load(os.path.join(FIX, "schedule.npz"))
    bounds = [p * man["train_iter"] for p in man["stair_points"]]
    stair = schedule.stair_decay(man["init_lr"], bounds, man["factor"])
    ours = np.array([stair(s) for s in range(man["n_steps"])])
    np.testing.assert_allclose(ours, z["stair_lr"], rtol=1e-6)
    for b in bounds:  # the boundary steps themselves hold the LEFT value
        assert ours[b] == ours[b - 1] and ours[b + 1] != ours[b]
    ms = schedule.multisteps(man["ms_values"], man["ms_bounds"])
    np.testing.assert_allclose([ms(s) for s in range(man["n_steps"])], z["ms_lr"], rtol=1e-6)


def test_build_schedule_matches_jax():
    from fisr_tpu.train import loop as jloop

    for lr_type in ("stair_decay", "linear_decay", "no_decay"):
        args = (lr_type, 1e-4, 4, 10, (2, 3), 0.1, 5)
        ours, theirs = loop.build_schedule(*args), jloop.build_schedule(*args)
        np.testing.assert_allclose([ours(s) for s in range(40)],
                                   [float(theirs(jnp.asarray(s))) for s in range(40)], rtol=1e-6)


# ---- the loss ------------------------------------------------------------------

@pytest.mark.parametrize("lam", [dict(), dict(recn=0.7, tm1=1.3, tm2=0.4, tmm=0.9, td=0.2, ss2=0.5)])
def test_temporal_loss_matches_jax(lam):
    rng = np.random.default_rng(0)
    shapes = [(2, 9, 16, 16, 3), (2, 9, 8, 8, 3), (2, 9, 4, 4, 3)]
    pred = [rng.uniform(size=s).astype(np.float32) for s in shapes]
    ss2 = [rng.uniform(size=(2, 3, *s[2:])).astype(np.float32) for s in shapes]
    gt = [rng.uniform(size=(2, 7, *s[2:])).astype(np.float32) for s in shapes]
    want_total, want = jlosses.temporal_loss(pred, ss2, gt, jlosses.LossWeights(**lam))
    tensors = [[torch.from_numpy(a).requires_grad_(True) for a in seq] for seq in (pred, ss2)]
    got_total, got = losses.temporal_loss(tensors[0], tensors[1],
                                          [torch.from_numpy(a) for a in gt],
                                          losses.LossWeights(**lam))
    assert list(got) == list(want) == TERMS
    for k in TERMS:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got_total.detach()), float(want_total), rtol=1e-5)
    # the stride-2 matching term sends its gradient into both branches
    got["tmLoss_ss2"].backward()
    assert tensors[0][0].grad.abs().max() > 0 and tensors[1][0].grad.abs().max() > 0


def test_temporal_loss_casts_to_f32():
    rng = np.random.default_rng(1)
    mk = lambda s: [torch.from_numpy(rng.uniform(size=(1, s, 8 // k, 8 // k, 3)).astype(np.float32))
                    for k in (1, 2, 4)]
    pred, ss2, gt = mk(9), mk(3), mk(7)
    total, metrics = losses.temporal_loss([p.bfloat16() for p in pred], [p.bfloat16() for p in ss2],
                                          gt)
    assert total.dtype == torch.float32 and all(v.dtype == torch.float32 for v in metrics.values())
    want, _ = losses.temporal_loss([p.bfloat16().float() for p in pred],
                                   [p.bfloat16().float() for p in ss2], gt)
    assert float(total) == float(want)


# ---- forward, train step, val step against JAX at ch=8 -------------------------

@pytest.fixture(scope="module")
def small():
    """A synthetic store and a ch=8 FISRnet tree on the oracle generator's
    damped weights (plain glorot weights blow level 3 up to O(10), where f32
    noise alone passes 1e-4)."""
    store = synth.synthetic_store(n_samples=6, h=32, w=32, seed=0, val_size=2)
    tree = params.to_jax_tree(params.deterministic_fisrnet(ch=8, device="cpu"))
    return store, jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("with_ss2", [True, False])
def test_forward_windows_matches_jax(small, with_ss2):
    store, tree = small
    batch = next(store.batches(2, epoch_seed=0))
    want_g, want_s = jtrainer.forward_windows(tree, _jbatch(batch), with_ss2=with_ss2)
    model = params.fisrnet_from_jax(_np_tree(tree), device="cpu")
    with torch.no_grad():
        got_g, got_s = trainer.forward_windows(model, trainer.batch_to_device(batch, "cpu"),
                                               with_ss2=with_ss2)
    assert [tuple(t.shape) for t in got_g] == [(2, 9, 64, 64, 3), (2, 9, 32, 32, 3),
                                               (2, 9, 16, 16, 3)]
    for got, want in zip(got_g, want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    if with_ss2:
        assert [tuple(t.shape) for t in got_s] == [(2, 3, 64, 64, 3), (2, 3, 32, 32, 3),
                                                   (2, 3, 16, 16, 3)]
        for got, want in zip(got_s, want_s):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    else:
        assert got_s is None and want_s is None


LR = 1e-4


def _assert_params_track(got_tree, want_tree):
    """Every parameter within rtol 2e-5 / atol 1e-7 (see the module docstring)."""
    got, want = _flat(got_tree), _flat(want_tree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=2e-5, atol=1e-7, err_msg=str(k))


def _assert_moments_track(model, opt, jax_adam_state):
    got = params.adam_state_to_jax(model, opt)
    assert int(got["count"]) == int(jax_adam_state.count)
    for field in ("mu", "nu"):
        want = _flat(_np_tree(getattr(jax_adam_state, field)))
        have = _flat(got[field])
        assert have.keys() == want.keys()
        for k, w in want.items():
            assert np.abs(have[k] - w).max() <= 1e-4 * np.abs(w).max() + 1e-12, (field, k)


def test_three_train_steps_match_jax(small):
    store, tree = small
    batch = next(store.batches(2, epoch_seed=0))
    # a boundary inside the three steps: step 2 must still see the left value
    jopt = jtrainer.adam_with_schedule(jschedule.stair_decay(LR, [2], 0.5))
    jstate = jtrainer.TrainState(tree, jopt.init(tree), jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(jopt, donate=False)
    model = params.fisrnet_from_jax(_np_tree(tree), device="cpu")
    state = trainer.TrainState(
        model, trainer.tf_adam(schedule.stair_decay(LR, [2], 0.5))(model.parameters()))
    step = trainer.make_train_step()
    for n in (1, 2, 3):
        jstate, want = jstep(jstate, _jbatch(batch))
        state, got = step(state, batch)
        assert state.step == n == int(jstate.step) and state.optimizer.count == n
        assert sorted(got) == sorted(want) and len(got) == 11
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-5, err_msg=f"{n} {k}")
            assert not got[k].requires_grad
        _assert_params_track(params.to_jax_tree(state.model), _np_tree(jstate.params))
        _assert_moments_track(state.model, state.optimizer, jstate.opt_state[0])
    assert state.optimizer.current_lr() == pytest.approx(LR * 0.5)  # step 3 > boundary 2


def test_jax_train_state_carries_across(small):
    """A JAX TrainState (params + ScaleByAdamState, as numpy) becomes a port
    state that computes the same next step; the port's checkpoint tree is the
    JAX tree."""
    store, tree = small
    batches = store.batches(2, epoch_seed=1)
    jopt = jtrainer.adam_with_schedule(jschedule.no_decay(LR))
    jstate = jtrainer.TrainState(tree, jopt.init(tree), jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(jopt, donate=False)
    for _ in range(2):
        jstate, _m = jstep(jstate, _jbatch(next(batches)))
    adam = jstate.opt_state[0]
    as_numpy = {"params": _np_tree(jstate.params),
                "opt_state": {"count": np.asarray(adam.count), "mu": _np_tree(adam.mu),
                              "nu": _np_tree(adam.nu)},
                "step": np.asarray(jstate.step)}
    state = trainer.create_state(3, trainer.tf_adam(schedule.no_decay(LR)), ch=8,
                                 device="cpu")
    state.step = params.load_train_state_(state.model, state.optimizer, as_numpy)
    assert state.step == 2 and state.optimizer.count == 2
    back = params.train_state_tree(state.model, state.optimizer, state.step)
    want_flat, got_flat = _flat(as_numpy), _flat(back)
    assert got_flat.keys() == want_flat.keys()
    for k, w in want_flat.items():
        np.testing.assert_array_equal(got_flat[k], w, err_msg=str(k))
    # the named tuple itself is accepted too
    params.load_adam_state_(state.model, state.optimizer, adam)
    batch = next(store.batches(2, epoch_seed=2))
    jstate, want = jstep(jstate, _jbatch(batch))
    state, got = trainer.make_train_step()(state, batch)
    np.testing.assert_allclose(float(got["total_loss"]), float(want["total_loss"]), rtol=2e-5)
    _assert_params_track(params.to_jax_tree(state.model), _np_tree(jstate.params))
    _assert_moments_track(state.model, state.optimizer, jstate.opt_state[0])


def test_val_step_matches_jax(small):
    store, tree = small
    vb = next(store.val_batches(2))
    want = jtrainer.make_val_step()(tree, _jbatch(vb))
    model = params.fisrnet_from_jax(_np_tree(tree), device="cpu")
    got = trainer.make_val_step()(model, vb)
    assert sorted(got) == ["val_PSNR", "val_recnLoss"]
    np.testing.assert_allclose(float(got["val_recnLoss"]), float(want["val_recnLoss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["val_PSNR"]), float(want["val_PSNR"]), rtol=1e-5)


def test_train_step_lowers_loss_on_one_batch(small):
    store, _ = small
    state = trainer.create_state(0, trainer.tf_adam(schedule.no_decay(2e-4)), ch=8,
                                 device="cpu")
    step = trainer.make_train_step()
    batch = next(store.batches(2, epoch_seed=0))
    totals = []
    for _ in range(6):
        state, m = step(state, batch)
        totals.append(float(m["total_loss"]))
    assert np.isfinite(totals).all() and totals[-1] < totals[0] and state.step == 6


# ---- TF-form Adam ---------------------------------------------------------------

def _np_tf_adam_step(var, m, v, g, lr, t, b1=0.9, b2=0.999, eps=1e-8):
    """Straight-line numpy port of tf.train.AdamOptimizer.apply_gradients."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    lr_t = lr * np.sqrt(1 - b2**t) / (1 - b1**t)
    return var - lr_t * m / (np.sqrt(v) + eps), m, v


def test_tfadam_matches_numpy_tf_adam():
    rng = np.random.default_rng(7)
    var = rng.normal(size=(4, 5)).astype(np.float32)
    scales = (1.0, 1e-2, 1e-7, 1.0, 1e-9, 0.3, 1e-6, 1.0, 1e-4, 2.0)
    grads = [rng.normal(size=var.shape).astype(np.float32) * s for s in scales]
    p = torch.nn.Parameter(torch.from_numpy(var.copy()))
    tiny = torch.nn.Parameter(torch.zeros(3))  # a leaf whose gradient stays near zero
    opt = trainer.TFAdam([p, tiny], 1e-3)
    ref, m, v = var.astype(np.float64), 0.0, 0.0
    ref_t, m_t, v_t = np.zeros(3), 0.0, 0.0
    for t, g in enumerate(grads, start=1):
        p.grad = torch.from_numpy(g)
        tiny.grad = torch.full((3,), 1e-9)
        opt.step()
        ref, m, v = _np_tf_adam_step(ref, m, v, g.astype(np.float64), 1e-3, t)
        ref_t, m_t, v_t = _np_tf_adam_step(ref_t, m_t, v_t, np.full(3, 1e-9), 1e-3, t)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=2e-5, atol=1e-8)
        np.testing.assert_allclose(tiny.detach().numpy(), ref_t, rtol=2e-5, atol=1e-10)
    assert opt.count == len(grads)


def test_torch_adam_is_not_tf_adam():
    """Why TFAdam exists: on a near-zero gradient torch.optim.Adam's first
    update is several times TF's (eps on the corrected against the
    uncorrected sqrt(v))."""
    def first_update(make):
        p = torch.nn.Parameter(torch.zeros(1))
        p.grad = torch.full((1,), 1e-9)
        make([p]).step()
        return float(p.detach())

    u_tf = first_update(lambda ps: trainer.TFAdam(ps, 1e-3))
    u_torch = first_update(lambda ps: torch.optim.Adam(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8))
    want, _, _ = _np_tf_adam_step(0.0, 0.0, 0.0, 1e-9, 1e-3, 1)
    assert u_tf == pytest.approx(want, rel=2e-5)
    assert abs(u_torch) > 5 * abs(u_tf), (u_tf, u_torch)


def test_tfadam_reads_the_schedule_before_it_counts():
    seen = []

    def sched(step):
        seen.append(step)
        return 0.1 if step == 0 else 0.0

    p = torch.nn.Parameter(torch.ones(2))
    opt = trainer.tf_adam(sched)([p])
    for _ in range(2):
        p.grad = torch.ones(2)
        opt.step()
    # step 0's rate moved the parameter, step 1's rate (0) did not
    assert seen == [0, 1] and opt.count == 2
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 0.1, rtol=1e-6)
    frozen = torch.nn.Parameter(torch.ones(2))
    opt = trainer.TFAdam([frozen], 0.1)
    opt.step()  # no gradient = a zero gradient: nothing moves, the count does
    assert opt.count == 1 and torch.equal(frozen.detach(), torch.ones(2))


# ---- stores ----------------------------------------------------------------------

def test_train_store_batch_stream_equals_jax():
    ours = synth.synthetic_store(n_samples=11, h=16, w=16, seed=4, val_size=3)
    theirs = jsynth.synthetic_store(n_samples=11, h=16, w=16, seed=4, val_size=3)
    assert ours.train_size == theirs.train_size == 8 and ours.num_batches(3) == 2
    for seed in (0, 5):
        a, b = list(ours.batches(3, epoch_seed=seed)), list(theirs.batches(3, epoch_seed=seed))
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert sorted(x) == sorted(BATCH_KEYS)
            for k in BATCH_KEYS:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    shard = list(ours.batches(2, epoch_seed=1, shard_index=1, shard_count=2))
    want = list(theirs.batches(2, epoch_seed=1, shard_index=1, shard_count=2))
    assert len(shard) == len(want) == 2 and np.array_equal(shard[0]["data"], want[0]["data"])
    for x, y in zip(ours.val_batches(1), theirs.val_batches(1)):
        assert sorted(x) == ["data", "flow", "label", "warp"]
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_train_store_from_files_equals_jax(tmp_path):
    paths = synth.write_synthetic_corpus(str(tmp_path / "c"), n_samples=4, h=16, w=16, seed=2)
    jpaths = jsynth.write_synthetic_corpus(str(tmp_path / "j"), n_samples=4, h=16, w=16, seed=2)
    assert sorted(os.listdir(tmp_path / "c")) == sorted(os.listdir(tmp_path / "j"))
    ours = TrainStore.from_files(**paths, val_size=1)
    # the JAX package's reader on the port's files: one on-disk contract
    from fisr_tpu.data.dataset import TrainStore as JStore

    theirs = JStore.from_files(**paths, val_size=1)
    for k in BATCH_KEYS:
        assert np.array_equal(getattr(ours, k), getattr(theirs, k)), k
    assert np.array_equal(JStore.from_files(**jpaths, val_size=1).label, ours.label)


def test_prefetch_to_device_on_cpu_is_a_plain_iterator():
    store = synth.synthetic_store(n_samples=6, h=16, w=16, seed=0, val_size=2)
    want = list(store.batches(2, epoch_seed=0))
    got = list(loop.prefetch_to_device(store.batches(2, epoch_seed=0), "cpu"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert all(isinstance(v, torch.Tensor) and np.array_equal(v.numpy(), w[k])
                   for k, v in g.items())


def test_read_metrics_is_float_of_each():
    m = {"a": torch.tensor(1.25), "b": torch.tensor(3.0e-7), "c": torch.tensor(1 / 3)}
    assert loop.read_metrics(m) == {k: float(v) for k, v in m.items()}


# ---- checkpoints ------------------------------------------------------------------

def test_derive_epoch_batch():
    assert checkpoint.derive_epoch_batch(1220 * 3 + 17, 1220) == (3, 17) == \
        jcheckpoint.derive_epoch_batch(1220 * 3 + 17, 1220)


@pytest.mark.parametrize("mode,keep,left,best", [(None, 2, [3, 4], 2), ("min", 2, [2, 4], 2),
                                                 ("max", 1, [3], 3)])
def test_checkpoint_retention(tmp_path, mode, keep, left, best):
    """Retention in all three modes, against the JAX manager's ledger on the
    same saves."""
    metrics = {1: 5.0, 2: 3.0, 3: 9.0, 4: 4.0}
    tree = {"params": {"a": {"w": np.arange(4.0, dtype=np.float32)}},
            "step": np.asarray(0, np.int32)}
    ours = checkpoint.CheckpointManager(str(tmp_path / "o"), max_to_keep=keep, best_mode=mode)
    theirs = jcheckpoint.CheckpointManager(str(tmp_path / "j"), max_to_keep=keep, best_mode=mode)
    for step, metric in metrics.items():
        t = {"params": {"a": {"w": tree["params"]["a"]["w"] + step}},
             "step": np.asarray(step, np.int32)}
        ours.save(step, t, metric=metric)
        theirs.save(step, t, metric=metric)
    dirs = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path / "o") if d.startswith("step_"))
    assert dirs == left
    assert dirs == sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path / "j")
                          if d.startswith("step_"))
    with open(tmp_path / "o" / "ledger.json") as f, open(tmp_path / "j" / "ledger.json") as g:
        assert json.load(f) == json.load(g)
    assert ours.latest_step() == theirs.latest_step() == max(left)
    if mode:
        assert ours.best_step() == theirs.best_step() == best
    got = ours.restore(left[0])
    np.testing.assert_array_equal(got["params"]["a"]["w"], tree["params"]["a"]["w"] + left[0])
    assert int(got["step"]) == left[0]
    assert not [d for d in os.listdir(tmp_path / "o") if d.startswith(".tmp")]


def test_checkpoint_save_is_atomic_and_orbax_directories_raise(tmp_path, monkeypatch):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"params": {"w": np.ones(2, np.float32)}})

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        mgr.save(2, {"params": {"w": np.zeros(2, np.float32)}})
    monkeypatch.undo()
    # the interrupted save is not the latest step, and the next save cleans up
    assert mgr.latest_step() == 1
    np.testing.assert_array_equal(mgr.restore()["params"]["w"], np.ones(2, np.float32))
    mgr.save(2, {"params": {"w": np.zeros(2, np.float32)}})
    assert mgr.latest_step() == 2 and sorted(os.listdir(tmp_path / "ck")) == ["ledger.json", "step_2"]
    with pytest.raises(FileNotFoundError):
        checkpoint.CheckpointManager(str(tmp_path / "empty")).restore()
    # a step directory that is neither this package's nor a whole orbax step
    # (an empty manifest.ocdbt without _METADATA) names the directory
    os.makedirs(tmp_path / "orbax" / "step_7")
    (tmp_path / "orbax" / "step_7" / "manifest.ocdbt").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match=r"orbax/step_7 holds neither tree\.npz"):
        checkpoint.CheckpointManager(str(tmp_path / "orbax")).restore()


# ---- fit ---------------------------------------------------------------------------

def test_fit_resumes_mid_epoch(tmp_path, capsys):
    """The scenario of tests/test_train.py: a checkpoint whose step is not an
    epoch multiple resumes at (epoch, batch), runs only the epoch's remaining
    batches of its own seeded permutation, and ends on the full schedule's
    step count. Full width (fit builds the reference model), 32x32 patches."""
    store = synth.synthetic_store(n_samples=10, h=32, w=32, seed=0, val_size=2)
    iters = store.num_batches(2)
    assert iters == 4
    ckpt, log = str(tmp_path / "ckpt"), str(tmp_path / "log")
    kw = dict(ckpt_dir=ckpt, batch_size=2, val_batch_size=2, lr_type="no_decay",
              freq_display=2, device="cpu")
    state = loop.fit(store, log_dir=log, epochs=1, **kw)
    assert state.step == iters and state.optimizer.count == iters
    out = capsys.readouterr().out
    assert "Epoch: [  0], [   0/   4], time: " in out and "Epoch: [  0], [   2/   4]" in out
    assert "######### Validation epoch [0/1]: val_PSNR " in out and " dB, recnLoss " in out
    with open(os.path.join(log, "metrics.jsonl")) as f:
        rec = json.loads(f.read().splitlines()[-1])
    assert rec["epoch"] == 0 and rec["step"] == iters
    assert set(TERMS) | {"train_PSNR", "val_PSNR", "val_recnLoss"} <= set(rec)
    events = glob.glob(os.path.join(log, "events.out.tfevents.*"))
    blob = open(events[0], "rb").read()
    assert b"total_loss" in blob and b"Seq3_Pred" in blob and b"Seq3_GT" in blob and b"\x89PNG" in blob

    # the saved tree restores bit for bit
    saved = checkpoint.CheckpointManager(ckpt).restore()
    fresh = trainer.create_state(9, trainer.tf_adam(1e-4), device="cpu")
    assert params.load_train_state_(fresh.model, fresh.optimizer, saved) == iters
    for a, b in zip(fresh.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)

    # an interruption at epoch 1, batch 2 (step 6): overwrite the per-epoch
    # checkpoint with a mid-epoch one
    checkpoint.CheckpointManager(ckpt).save(
        iters + 2, params.train_state_tree(state.model, state.optimizer, iters + 2))
    seen = []
    real = store.batches
    store.batches = lambda bs, epoch_seed: (seen.append(epoch_seed), real(bs, epoch_seed))[1]
    resumed = loop.fit(store, epochs=2, step_timeout_s=600, **kw)
    out = capsys.readouterr().out
    assert f" [*] resumed from step {iters + 2} (epoch 1, batch 2)" in out
    assert "Epoch: [  1], [   2/   4]" in out and "[   0/   4]" not in out
    assert resumed.step == 2 * iters and seen == [1]
    assert checkpoint.CheckpointManager(ckpt).latest_step() == 2 * iters


def test_fit_disarms_the_watchdog_when_a_step_raises(tmp_path):
    store = synth.synthetic_store(n_samples=4, h=32, w=32, seed=0, val_size=2)
    store.flow = store.flow[..., :3]  # a bad batch: the window slicing fails
    import threading

    with pytest.raises(RuntimeError):
        loop.fit(store, ckpt_dir=str(tmp_path / "ck"), epochs=1, batch_size=2,
                 step_timeout_s=600, device="cpu")
    assert not [t for t in threading.enumerate() if t.name.startswith("watchdog:")]


# ---- the TF-oracle fixtures, full width ------------------------------------------------

@pytest.fixture(scope="module")
def oracle_model():
    with open(os.path.join(FIX, "train_loss_manifest.json")) as f:
        man = json.load(f)
    model = params.deterministic_fisrnet(device="cpu")
    name_map = params.fisrnet_name_map()
    flat = _flat(params.to_jax_tree(model))
    tf_vars = {n: flat[p] for n, p in name_map.items()}
    assert tf_vars_digest(deterministic_tf_vars({n: a.shape for n, a in tf_vars.items()})) == \
        man["weights_digest"]
    return man, np.load(os.path.join(FIX, "train_loss.npz")), model, tf_vars


def test_loss_terms_and_gradients_match_tf_oracle(oracle_model):
    man, z, model, _ = oracle_model
    batch = {k: torch.from_numpy(z[k]) for k in BATCH_KEYS}
    model.zero_grad(set_to_none=True)
    pg, ps2 = trainer.forward_windows(model, batch)
    gt = trainer._gt_pyramid(batch["label"])
    total, metrics = losses.temporal_loss(pg, ps2, gt)
    from fisr_tpu_torch.ops.metrics import psnr_image
    from fisr_tpu_torch.ops.seq import groups_to_overlap

    metrics["train_PSNR"] = torch.mean(psnr_image(groups_to_overlap(pg[0]).detach(), gt[0]))
    for i, t in enumerate(TERMS + ["train_PSNR"]):
        ref = float(z["loss_terms"][i])
        got = float(metrics[t].detach())
        assert abs(got - ref) / max(abs(ref), 1e-9) < 1e-5, (t, got, ref)
    total.backward()
    grads = _flat(params._jax_tree((k, p.grad) for k, p in model.named_parameters()))
    name_map = params.fisrnet_name_map()
    for i, name in enumerate(man["grad_vars"]):
        ref = z[f"grad_{i}"]
        assert np.abs(grads[name_map[name]] - ref).max() < 3e-5 * np.abs(ref).max() + 1e-9, name
    model.zero_grad(set_to_none=True)


def test_val_branch_matches_tf_oracle(oracle_model):
    _, z, model, _ = oracle_model
    out = trainer.make_val_step()(model, {k: z[f"val_{k}"] for k in ("data", "label", "flow", "warp")})
    assert abs(float(out["val_recnLoss"]) - float(z["val_recnLoss"])) < 1e-5
    assert abs(float(out["val_PSNR"]) - float(z["val_PSNR"])) < 1e-3


def test_three_optimizer_steps_match_tf_oracle(oracle_model):
    """tf.train.AdamOptimizer's own three steps of the reference graph
    (optimizer.npz): every stored small leaf after steps 1 and 3, and the
    delta digests of all leaves after step 3, at the JAX test's bounds."""
    _, zl, _, tf_vars = oracle_model
    with open(os.path.join(FIX, "optimizer_manifest.json")) as f:
        man = json.load(f)
    z = np.load(os.path.join(FIX, "optimizer.npz"))
    sched = schedule.stair_decay(1e-4, [80, 90], 0.1)
    for step, lr_ref in enumerate(man["lr_steps"]):
        assert abs(sched(step) - lr_ref) < 1e-9
    model = params.deterministic_fisrnet(device="cpu")
    state = trainer.TrainState(model, trainer.tf_adam(sched)(model.parameters()))
    step_fn = trainer.make_train_step()
    batch = {k: zl[k] for k in BATCH_KEYS}
    name_map = params.fisrnet_name_map()
    exported = {}
    for step in range(1, man["n_steps"] + 1):
        state, _m = step_fn(state, batch)
        if step in (1, man["n_steps"]):
            flat = _flat(params.to_jax_tree(state.model))
            exported[step] = {n: flat[p].astype(np.float64) for n, p in name_map.items()}
    for step in (1, man["n_steps"]):
        for n in man["small_names"]:
            ref_d = z[f"s{step}__{n}"].astype(np.float64) - tf_vars[n]
            our_d = exported[step][n] - tf_vars[n]
            scale = max(np.abs(ref_d).max(), 1e-12)
            assert np.abs(our_d - ref_d).max() < 0.1 * scale + 1e-10, (step, n)
    final = exported[man["n_steps"]]
    for i, n in enumerate(man["names"]):
        d = final[n] - tf_vars[n]
        ours = np.array([np.sqrt((d * d).sum()), np.abs(d).max(), np.abs(d).sum()])
        rel = np.abs(ours - z["delta_digests"][i]) / np.maximum(np.abs(z["delta_digests"][i]), 1e-12)
        assert rel.max() < 2e-3, (n, ours, z["delta_digests"][i])


# ---- utilities -----------------------------------------------------------------------

def test_param_summary_matches_jax(capsys):
    tree = jfisr.init_params(jax.random.PRNGKey(0), ch=8)
    model = params.fisrnet_from_jax(_np_tree(tree), device="cpu")
    assert summary.param_table(model) == jsummary.param_table(tree)
    total = summary.print_params(model, name="FISRnet")
    ours = capsys.readouterr().out
    assert total == jsummary.print_params(tree, name="FISRnet")
    assert ours == capsys.readouterr().out and "--- FISRnet variables ---" in ours


def test_tb_writer_records_match_jax(tmp_path):
    for data in (b"", b"brain.Event:2", bytes(range(256)) * 3):
        assert tb_writer.crc32c(data) == jtb.crc32c(data)
        assert tb_writer._masked_crc(data) == jtb._masked_crc(data)
    assert tb_writer._scalar_value("loss", 0.25) == jtb._scalar_value("loss", 0.25)
    tb = tb_writer.TBLogger(str(tmp_path))
    tb.log_scalars({"a": 1.0, "b": 2.0}, 3)
    img = np.random.default_rng(0).integers(0, 255, (6, 8, 3)).astype(np.uint8)
    tb.log_image("img", img, 3)
    tb.close()
    blob = open(tb.path, "rb").read()
    assert b"brain.Event:2" in blob and b"img" in blob
    # the embedded PNG decodes to the image
    from fisr_tpu_torch.data.png_io import read_png

    start = blob.index(b"\x89PNG")
    (tmp_path / "x.png").write_bytes(blob[start:blob.index(b"IEND", start) + 8])
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), img)


def test_heartbeat_fires_and_disarms():
    import time

    fired = []
    hb = Heartbeat(0.05, on_timeout=fired.append, poll_s=0.01).start()
    time.sleep(0.3)
    hb.stop()
    assert len(fired) == 1 and fired[0] > 0.05 and EXIT_CODE == 86
    with Heartbeat(2.0, on_timeout=fired.append, poll_s=0.02) as hb:
        for _ in range(6):
            time.sleep(0.05)
            hb.beat()
    assert len(fired) == 1
    with pytest.raises(ValueError):
        Heartbeat(0)


# ---- the CLI's train phase ---------------------------------------------------------------

def test_cli_train_phase_end_to_end(tmp_path, capsys):
    """train (one epoch) -> checkpoint -> the test phase on the trained
    weights, on a written synthetic corpus, on the CPU; then the test phase
    alone restores that checkpoint, and a second train call resumes."""
    from fisr_tpu_torch.cli.main import main

    corpus = synth.write_synthetic_corpus(str(tmp_path / "train"), n_samples=4, h=32, w=32)
    test = synth.write_synthetic_test_set(str(tmp_path / "test"), n_scenes=1, h=32, w=32)
    args = ["--device", "cpu", "--compute_dtype", "float32",
            "--train_data_path", corpus["data_path"], "--train_label_path", corpus["label_path"],
            "--train_flow_data_path", corpus["flow_path"],
            "--train_flow_ss2_data_path", corpus["flow_ss2_path"],
            "--train_warped_data_path", corpus["warp_path"],
            "--train_wapred_ss2_data_path", corpus["warp_ss2_path"],
            "--test_data_path", test["test_data_path"], "--test_label_path", test["test_label_path"],
            "--test_flow_data_path", test["test_flow_data_path"],
            "--test_warped_data_path", test["test_warped_data_path"],
            "--test_input_size", "32", "32", "--test_patch", "1", "1",
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "log"),
            "--text_dir", str(tmp_path / "text"), "--test_img_dir", str(tmp_path / "imgs"),
            "--val_data_size", "2", "--batch_size", "2", "--val_batch_size", "2",
            "--epoch", "1", "--freq_display", "1", "--exp_num", "3"]
    res = main(["--phase", "train"] + args)
    out = capsys.readouterr().out
    assert "--- FISRnet variables ---" in out and "[*] Training finished! Testing starts" in out
    assert " [*] restored checkpoint step 1" in out
    assert os.path.isdir(tmp_path / "ckpt" / "FISRnet_exp3" / "step_1")
    with open(tmp_path / "log" / "FISRnet_exp3" / "metrics.jsonl") as f:
        rec = json.loads(f.read().splitlines()[-1])
    assert {"recnLoss", "tmLoss", "tmmLoss", "tdLoss", "val_PSNR"} <= set(rec)
    dump = (tmp_path / "text" / "exp_3.txt").read_text()
    assert dump.startswith("----- Model parameters -----\n") and "train_wapred_ss2_data_path : " in dump
    assert len(glob.glob(str(tmp_path / "imgs" / "FISRnet_exp3" / "pred_*.png"))) == 7
    assert res.n_frames == 7 and np.isfinite(res.psnr_vfi_sr)
    again = main(["--phase", "test"] + args)
    assert " [*] restored checkpoint step 1" in capsys.readouterr().out
    assert again.psnr_vfi_sr == res.psnr_vfi_sr and again.ssim_sr == res.ssim_sr
    main(["--phase", "train"] + args[:-4] + ["--epoch", "2", "--exp_num", "3"])
    out = capsys.readouterr().out
    assert " [*] resumed from step 1 (epoch 1, batch 0)" in out
    assert os.listdir(tmp_path / "ckpt" / "FISRnet_exp3") and \
        checkpoint.CheckpointManager(str(tmp_path / "ckpt" / "FISRnet_exp3")).latest_step() == 2
    # an experiment without a checkpoint falls back to a fresh init, and says so
    fresh = main(["--phase", "test"] + args[:-2] + ["--exp_num", "4"])
    assert " [!] no checkpoint found: using fresh init" in capsys.readouterr().out
    assert fresh.n_frames == 7 and fresh.psnr_vfi_sr != res.psnr_vfi_sr
    assert not os.path.exists(tmp_path / "ckpt" / "FISRnet_exp4")
    # weights named by a flag win over the experiment's checkpoint
    named = main(["--phase", "test", "--deterministic_weights"] + args)
    assert "restored checkpoint" not in capsys.readouterr().out
    assert named.n_frames == 7 and named.psnr_vfi_sr != res.psnr_vfi_sr
