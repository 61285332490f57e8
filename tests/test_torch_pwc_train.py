"""Port: PWC-Net training (pyramid losses, EPE, the train and eval steps,
the eval report, pwc_fit, the flow dataset, augmentation and the flow
visualisation) against the JAX package, f32, CPU.

Tolerances, with what was measured here:
* pwcnet_loss in both modes with the weight decay, `_level_gt`, `epe`:
  rtol 1e-5 (measured 2.4e-7).
* three make_pwc_train_step steps (pyr_lvls=4, search range 2, 64x64,
  batch 2, the oracle generator's damped weights, the JAX side on its XLA
  cost volume), in both loss modes: loss rtol 2e-5 (measured 3e-7), every
  parameter rtol 2e-5 / atol 1e-7 after each step (measured 1.7e-7 absolute
  at the third step, none of 6,394,378 entries outside the bound), Adam's
  moments within 1e-4 of each leaf's largest entry.
* FlowDataset batch streams, augment_pair, the corpus generators, the ID
  files and the flow rendering: equal (np.array_equal).
* pwc_eval_report rows: EPE and flow magnitudes rtol 1e-4 of the JAX rows.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fisr_tpu.data import augment as jaugment
from fisr_tpu.data.flow_dataset import FlowDataset as JFlowDataset
from fisr_tpu.models import pwcnet as jpwcnet
from fisr_tpu.train import pwc_loss as jpwc_loss
from fisr_tpu.train import pwc_trainer as jpwc_trainer
from fisr_tpu.train import schedule as jschedule
from fisr_tpu.train import trainer as jtrainer
from fisr_tpu.utils import flow_viz as jflow_viz
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.data import augment
from fisr_tpu_torch.data.flo import read_flo
from fisr_tpu_torch.data.flow_dataset import FlowDataset
from fisr_tpu_torch.data.png_io import read_png
from fisr_tpu_torch.models import pwcnet
from fisr_tpu_torch.train import checkpoint, pwc_loss, pwc_trainer, schedule, trainer
from fisr_tpu_torch.utils import flow_viz

torch.set_num_threads(1)
SMALL = dict(pyr_lvls=4, flow_pred_lvl=2, search_range=2)
JCFG = jpwcnet.PWCNetConfig(**SMALL, cost_volume_impl="xla")
LR = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return dict(params.flatten_tree(tree))


def _small_tree():
    """A pyr_lvls=4 PWC-Net tree on the oracle generator's damped weights."""
    model = params.deterministic_pwcnet(pwcnet.PWCNetConfig(**SMALL), device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, params.to_jax_tree(model))


def _batch(seed=1, b=2, h=64, w=64):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(size=(b, 2, h, w, 3)).astype(np.float32),
            "y": rng.normal(size=(b, h, w, 2)).astype(np.float32)}


# ---- losses ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["multiscale", "robust"])
def test_pwcnet_loss_matches_jax(mode):
    rng = np.random.default_rng(0)
    y = (rng.normal(size=(2, 32, 48, 2)) * 4).astype(np.float32)
    pyr = [rng.normal(size=(2, 32 // 2**l, 48 // 2**l, 2)).astype(np.float32) for l in (4, 3, 2)]
    leaves = {"a": {"w": rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
                    "b": rng.normal(size=(5,)).astype(np.float32)}}
    kw = dict(mode=mode, epsilon=0.02, q=0.5, gamma=0.001)
    want = float(jpwc_loss.pwcnet_loss(jnp.asarray(y), [jnp.asarray(p) for p in pyr], leaves, **kw))
    tensors = [torch.from_numpy(a) for a in (leaves["a"]["w"], leaves["a"]["b"])]
    got = pwc_loss.pwcnet_loss(torch.from_numpy(y), [torch.from_numpy(p) for p in pyr],
                               tensors, **kw)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # without the decay, and the decay alone counts the bias too
    want0 = float(jpwc_loss.pwcnet_loss(jnp.asarray(y), [jnp.asarray(p) for p in pyr], None, **kw))
    got0 = pwc_loss.pwcnet_loss(torch.from_numpy(y), [torch.from_numpy(p) for p in pyr], None, **kw)
    np.testing.assert_allclose(float(got0), want0, rtol=1e-5)
    decay = 0.001 * 0.5 * sum(float((a.astype(np.float64) ** 2).sum())
                              for a in (leaves["a"]["w"], leaves["a"]["b"]))
    np.testing.assert_allclose(float(got) - float(got0), decay, rtol=1e-4)
    with pytest.raises(ValueError):
        pwc_loss.pwcnet_loss(torch.from_numpy(y), [torch.from_numpy(pyr[0])], mode="l1")


def test_level_gt_and_epe_match_jax():
    rng = np.random.default_rng(2)
    y = (rng.normal(size=(1, 32, 32, 2)) * 4).astype(np.float32)
    for hw in ((8, 8), (4, 4), (16, 16)):
        np.testing.assert_allclose(pwc_loss._level_gt(torch.from_numpy(y), hw).numpy(),
                                   np.asarray(jpwc_loss._level_gt(jnp.asarray(y), hw)),
                                   rtol=1e-6, atol=1e-7)
    # level-pixel units: a constant 4-px flow is 1 px at level 2 and comes back
    const = torch.full((1, 32, 32, 2), 4.0)
    np.testing.assert_allclose(pwc_loss._level_gt(const, (8, 8)).numpy(), 1.0, rtol=1e-6)
    a = rng.normal(size=(2, 8, 8, 2)).astype(np.float32)
    np.testing.assert_allclose(float(pwc_loss.epe(torch.from_numpy(a), torch.from_numpy(y[:, :8, :8]))),
                               float(jpwc_loss.epe(jnp.asarray(a), jnp.asarray(y[:, :8, :8]))),
                               rtol=1e-5)
    b = np.zeros((1, 4, 4, 2), np.float32)
    b[..., 0], b[..., 1] = 3.0, 4.0
    assert abs(float(pwc_loss.epe(torch.zeros(1, 4, 4, 2), torch.from_numpy(b))) - 5.0) < 1e-6


def test_multiscale_loss_gradient_is_finite_at_zero_error():
    y = torch.zeros(1, 16, 16, 2)
    flow = torch.zeros(1, 4, 4, 2, requires_grad=True)
    loss = pwc_loss.pwcnet_loss(y, [flow], None, alphas=(0.32,))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(0.32 * 16 * 1e-8, rel=1e-4)
    assert torch.isfinite(flow.grad).all() and float(flow.grad.abs().max()) == 0.0


# ---- the train and eval steps -----------------------------------------------------

def _assert_params_track(got_tree, want_tree):
    """Every parameter within rtol 2e-5 / atol 1e-7 (see the module docstring)."""
    got, want = _flat(got_tree), _flat(want_tree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=2e-5, atol=1e-7, err_msg=str(k))


@pytest.mark.parametrize("mode", ["multiscale", "robust"])
def test_three_pwc_train_steps_match_jax(mode):
    tree = _small_tree()
    batch = _batch()
    jopt = jtrainer.adam_with_schedule(jschedule.multisteps([LR, LR / 2], [2]))
    jstate = jtrainer.TrainState(tree, jopt.init(tree), jnp.zeros((), jnp.int32))
    jstep = jpwc_trainer.make_pwc_train_step(jopt, JCFG, loss_mode=mode, donate=False)
    cfg = pwcnet.PWCNetConfig(**SMALL)
    model = params.pwcnet_from_jax(_np_tree(tree), cfg, device="cpu")
    opt = trainer.tf_adam(schedule.multisteps([LR, LR / 2], [2]))(model.parameters())
    state = trainer.TrainState(model, opt)
    step = pwc_trainer.make_pwc_train_step(cfg, loss_mode=mode)
    for n in (1, 2, 3):
        jstate, want = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, got = step(state, batch)
        assert state.step == n and list(got) == ["loss"] and not got["loss"].requires_grad
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-5)
        _assert_params_track(params.to_jax_tree(state.model), _np_tree(jstate.params))
        have = params.adam_state_to_jax(state.model, state.optimizer)
        for field in ("mu", "nu"):
            ref = _flat(_np_tree(getattr(jstate.opt_state[0], field)))
            for k, v in _flat(have[field]).items():
                assert np.abs(v - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max() + 1e-12, (field, k)
    assert state.optimizer.current_lr() == pytest.approx(LR / 2)


def test_pwc_eval_step_matches_jax_and_step_lowers_loss():
    tree = _small_tree()
    batch = _batch(3)
    want = jpwc_trainer.make_pwc_eval_step(JCFG)(tree, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = pwcnet.PWCNetConfig(**SMALL)
    state = pwc_trainer.create_pwc_state(0, trainer.tf_adam(schedule.no_decay(LR)), cfg,
                                         device="cpu")
    params._load_tree_(state.model, _np_tree(tree))
    got = pwc_trainer.make_pwc_eval_step()(state.model, batch)
    np.testing.assert_allclose(float(got["epe"]), float(want["epe"]), rtol=1e-5)
    step = pwc_trainer.make_pwc_train_step(gamma=0.0)
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] and state.step == 6


def test_pwc_train_step_runs_in_bf16():
    from fisr_tpu_torch.ops.conv import BF16

    cfg = pwcnet.PWCNetConfig(**SMALL)
    state = pwc_trainer.create_pwc_state(0, trainer.tf_adam(LR), cfg, device="cpu")
    before = [p.detach().clone() for p in state.model.parameters()]
    state, m = pwc_trainer.make_pwc_train_step(policy=BF16)(state, _batch(4))
    assert m["loss"].dtype == torch.float32 and np.isfinite(float(m["loss"]))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(before, state.model.parameters()))


# ---- the dataset ---------------------------------------------------------------------

def test_corpus_generators_equal_jax():
    for make in (lambda c: c.synthetic(n=5, h=24, w=32, seed=3),
                 lambda c: c.synthetic_textured(n=4, h=40, w=40, seed=5),
                 lambda c: c.synthetic_textured(n=3, h=32, w=48, seed=6, max_shift=2.5,
                                                subpixel=False)):
        ours, theirs = make(FlowDataset), make(JFlowDataset)
        assert ours.pairs.dtype == np.uint8 and np.array_equal(ours.pairs, theirs.pairs)
        assert np.array_equal(ours.flows, theirs.flows)
        assert (ours.train_size, ours.val_size) == (theirs.train_size, theirs.val_size)


@pytest.mark.parametrize("workers", [0, 2])
def test_flow_dataset_batch_stream_equals_jax(workers):
    def make(cls, aug_cls):
        return cls.synthetic_textured(n=10, h=40, w=40, seed=5, crop_hw=(32, 32),
                                      aug=aug_cls(), val_split=0.2)

    ours, theirs = make(FlowDataset, augment.AugmentOptions), make(JFlowDataset,
                                                                  jaugment.AugmentOptions)
    for epoch_seed in (1, 2):  # the sample RNG runs on across epochs
        a = list(ours.batches(2, train=True, epoch_seed=epoch_seed, num_workers=workers))
        b = list(theirs.batches(2, train=True, epoch_seed=epoch_seed))
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x["x"].dtype == x["y"].dtype == np.float32
            assert np.array_equal(x["x"], y["x"]) and np.array_equal(x["y"], y["y"])
    va = list(ours.batches(3, train=False, num_workers=workers))
    vb = list(theirs.batches(3, train=False))
    assert [len(v["x"]) for v in va] == [len(v["x"]) for v in vb] == [2]  # the partial batch
    assert np.array_equal(va[0]["x"], vb[0]["x"]) and va[0]["x"].shape == (2, 2, 32, 32, 3)


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_augment_pair_equals_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, size=(2, 24, 32, 3)).astype(np.float32)
    y = rng.normal(size=(24, 32, 2)).astype(np.float32)
    opts = dict(translate_frac=0.2, scale_frac=0.1)
    got = augment.augment_pair(x, y, augment.AugmentOptions(**opts), np.random.default_rng(seed))
    want = jaugment.augment_pair(x, y, jaugment.AugmentOptions(**opts), np.random.default_rng(seed))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    img = rng.uniform(size=(16, 20, 3))
    for ratio in (0.93, 1.0, 1.07):
        assert np.array_equal(augment.scale_keep_size(img, ratio),
                              jaugment.scale_keep_size(img, ratio))


def test_from_folder_persists_the_split_like_jax(tmp_path):
    from fisr_tpu_torch.data.flo import write_flo
    from fisr_tpu_torch.data.png_io import write_png

    src = FlowDataset.synthetic(n=5, h=16, w=16, seed=1)
    for folder in ("ours", "theirs"):
        os.makedirs(tmp_path / folder)
        for i in range(5):
            write_png(src.pairs[i, 0], tmp_path / folder / f"s{i}_img1.png")
            write_png(src.pairs[i, 1], tmp_path / folder / f"s{i}_img2.png")
            write_flo(src.flows[i], str(tmp_path / folder / f"s{i}_flow.flo"))
    ours = FlowDataset.from_folder(str(tmp_path / "ours"), val_split=0.4)
    theirs = JFlowDataset.from_folder(str(tmp_path / "theirs"), val_split=0.4)
    assert ours.ids == theirs.ids and (ours.train_size, ours.val_size) == (3, 2)
    assert np.array_equal(ours.pairs, theirs.pairs) and np.array_equal(ours.flows, theirs.flows)
    for name in ("train_0.4split.txt", "val_0.4split.txt"):
        assert (tmp_path / "ours" / name).read_text() == (tmp_path / "theirs" / name).read_text()
    # a later load reuses the files, and a sample they name must exist
    again = FlowDataset.from_folder(str(tmp_path / "ours"), val_split=0.4)
    assert again.ids == ours.ids
    os.remove(tmp_path / "ours" / "s4_img1.png")
    with pytest.raises(FileNotFoundError, match="missing samples"):
        FlowDataset.from_folder(str(tmp_path / "ours"), val_split=0.4)
    with pytest.raises(ValueError, match="split_sizes"):
        FlowDataset(src.pairs, src.flows, split_sizes=(2, 2))


def test_flow_viz_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    flow = rng.normal(size=(12, 16, 2)).astype(np.float32) * 3
    gt = rng.normal(size=(12, 16, 2)).astype(np.float32)
    img = rng.uniform(size=(2, 12, 16, 3))
    assert np.array_equal(flow_viz.flow_to_img(flow), jflow_viz.flow_to_img(flow))
    assert np.array_equal(flow_viz.flow_panel(img[0], img[1], flow, warped=img[1], flow_gt=gt),
                          jflow_viz.flow_panel(img[0], img[1], flow, warped=img[1], flow_gt=gt))
    batch = (np.stack([img] * 2), np.stack([flow] * 2))
    assert np.array_equal(flow_viz.flow_panels(*batch, flow_gts=np.stack([gt] * 2)),
                          jflow_viz.flow_panels(*batch, flow_gts=np.stack([gt] * 2)))
    flow_viz.write_pfm(str(tmp_path / "f.pfm"), flow[..., 0])
    (got, scale), (want, jscale) = flow_viz.read_pfm(str(tmp_path / "f.pfm")), \
        jflow_viz.read_pfm(str(tmp_path / "f.pfm"))
    assert scale == jscale == 1.0 and np.array_equal(got, want) and np.array_equal(got, flow[..., 0])
    flow_viz.write_kitti_png(str(tmp_path / "k.png"), flow)
    got, want = flow_viz.read_kitti_png(str(tmp_path / "k.png")), \
        jflow_viz.read_kitti_png(str(tmp_path / "k.png"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    (tmp_path / "bad.png").write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="not a png"):
        flow_viz.read_kitti_png(str(tmp_path / "bad.png"))


# ---- the eval report and pwc_fit --------------------------------------------------------

def test_pwc_eval_report_matches_jax(tmp_path):
    small = dict(pyr_lvls=3, flow_pred_lvl=2, search_range=2)
    cfg = pwcnet.PWCNetConfig(**small)
    model = params.deterministic_pwcnet(cfg, device="cpu")
    tree = jax.tree_util.tree_map(jnp.asarray, params.to_jax_tree(model))
    ds, jds = FlowDataset.synthetic(n=5, h=32, w=32), JFlowDataset.synthetic(n=5, h=32, w=32)
    report, preds = str(tmp_path / "report.jsonl"), str(tmp_path / "preds")
    avg_epe, avg_dur, rows = pwc_trainer.pwc_eval_report(
        model, ds, batch_size=1, save_preds_dir=preds, report_path=report)
    _, _, want = jpwc_trainer.pwc_eval_report(
        tree, jds, batch_size=1, cfg=jpwcnet.PWCNetConfig(**small, cost_volume_impl="xla"))
    assert len(rows) == len(want) == ds.val_size and avg_dur > 0
    for r, w in zip(rows, want):
        assert list(r) == ["ID", "EPE", "Duration", "Avg_Flow_Mag", "Max_Flow_Mag"]
        assert r["ID"] == w["ID"] and r["Max_Flow_Mag"] >= r["Avg_Flow_Mag"]
        for k in ("EPE", "Avg_Flow_Mag", "Max_Flow_Mag"):
            np.testing.assert_allclose(r[k], w[k], rtol=1e-4, err_msg=k)
    assert avg_epe == sum(r["EPE"] for r in rows) / len(rows)
    with open(report) as f:
        assert [json.loads(line) for line in f] == rows
    flos = sorted(f for f in os.listdir(preds) if f.endswith(".flo"))
    pngs = sorted(f for f in os.listdir(preds) if f.endswith(".png"))
    assert len(flos) == len(pngs) == len(rows) and flos[0] == "val_00000_flow_pred.flo"
    pred = read_flo(os.path.join(preds, flos[0]))
    assert pred.shape == (32, 32, 2)
    assert np.array_equal(read_png(os.path.join(preds, pngs[0])), flow_viz.flow_to_img(pred))


def test_pwc_fit_end_to_end(tmp_path, capsys):
    ds = FlowDataset.synthetic(n=6, h=32, w=32, val_split=0.34)
    cfg = pwcnet.PWCNetConfig(**SMALL)
    state = pwc_trainer.pwc_fit(ds, str(tmp_path / "ck"), steps=4, batch_size=2, val_every=2,
                                display_every=2, cfg=cfg, schedule_fn=schedule.no_decay(LR),
                                max_to_keep=1, log_dir=str(tmp_path / "tb"), device="cpu")
    out = capsys.readouterr().out
    assert state.step == 4 and "step 0/4 loss " in out and "step 2/4 loss " in out
    assert "step 2: val EPE " in out and "step 4: val EPE " in out
    # top-k by EPE: one kept, the better of the two rounds
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"), best_mode="min")
    with open(tmp_path / "ck" / "ledger.json") as f:
        entries = json.load(f)["entries"]
    epes = [float(line.split()[-1]) for line in out.splitlines() if "val EPE" in line]
    assert len(entries) == 1 and entries[0]["step"] == (2 if epes[0] <= epes[1] else 4)
    assert entries[0]["metric"] == pytest.approx(min(epes), abs(1e-4)) and \
        mgr.best_step() == entries[0]["step"]
    tree = mgr.restore(mgr.best_step())
    assert int(tree["step"]) == entries[0]["step"] == int(tree["opt_state"]["count"])
    params.pwcnet_from_jax(tree["params"], cfg, device="cpu")
    blob = open(glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))[0], "rb").read()
    assert b"train/loss" in blob and b"val/EPE" in blob
    assert b"val/flow_panel" in blob and b"\x89PNG" in blob
