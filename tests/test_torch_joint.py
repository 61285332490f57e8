"""Port: the joint fine-tune step (gradients through flow -> warp ->
FISRnet) against the JAX package, f32, CPU.

Sizes: FISRnet ch=8 and PWC-Net pyr_lvls=4, search range 2, both on the
oracle generator's damped weights; windows of 32x32, batch 2 (batch 1 in the
frozen case). Tolerances, with what was measured here: joint_loss and
joint_PSNR rtol 2e-5 (measured 4e-7); every parameter of both models after
the step rtol 2e-5 / atol 1e-7, but for at most 0.01 % of the entries, which
may be up to 2*lr apart (measured: 1 of FISRnet's 765,699 entries, a bias
whose gradient is f32 noise, 1.9e-7 = 0.002 lr off; none of PWC-Net's
6,394,378; Adam's first update is about sign(g)*lr, so such an entry could
flip); Adam's moments within 1e-3 of each leaf's largest entry (measured 2.2e-4 on
the second moment of the last bias, whose gradient is a sum of +-1-like
Charbonnier terms that cancel) plus 1e-5 of
the tree's (the noise of a backward pass does not shrink with the leaf;
measured 1.5e-6 of the tree's largest on a bias of level 3's first encoder).
With a frozen flow model FISRnet's update is bit-equal
to the one it gets beside a training flow model. dense_image_warp:
`torch.autograd.gradcheck` in f64 in image and flow.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fisr_tpu.data import synth as jsynth
from fisr_tpu.models import pwcnet as jpwcnet
from fisr_tpu.train import joint as jjoint
from fisr_tpu.train import trainer as jtrainer
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.data import synth
from fisr_tpu_torch.models import pwcnet
from fisr_tpu_torch.ops.warp import dense_image_warp
from fisr_tpu_torch.train import joint, trainer

torch.set_num_threads(1)
SMALL = dict(pyr_lvls=4, flow_pred_lvl=2, search_range=2)
JCFG = jpwcnet.PWCNetConfig(**SMALL, cost_volume_impl="xla")
LR_F, LR_P = 1e-4, 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return dict(params.flatten_tree(tree))


@pytest.fixture(scope="module")
def trees():
    fisr = params.to_jax_tree(params.deterministic_fisrnet(ch=8, device="cpu"))
    pwc = params.to_jax_tree(params.deterministic_pwcnet(pwcnet.PWCNetConfig(**SMALL),
                                                         device="cpu"))
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    return as_jax(fisr), as_jax(pwc)


def _batch(n=2, seed=0):
    frames, target = synth.synthetic_video_windows(n, h=32, w=32, seed=seed)
    return {"frames": frames, "target": target}


def _port_state(trees, train_pwc):
    fisr, pwc = trees
    return joint.create_joint_state(
        params.fisrnet_from_jax(_np_tree(fisr), device="cpu"),
        params.pwcnet_from_jax(_np_tree(pwc), pwcnet.PWCNetConfig(**SMALL), device="cpu"),
        trainer.tf_adam(LR_F), trainer.tf_adam(LR_P) if train_pwc else None)


def _assert_close_trees(got_tree, want_tree, lr, loose_share=1e-4):
    """Every parameter within rtol 2e-5 / atol 1e-7 after one Adam step but
    for `loose_share` of the entries, which may be up to 2*lr apart (see the
    module docstring)."""
    got, want = _flat(got_tree), _flat(want_tree)
    assert got.keys() == want.keys()
    loose = total = 0
    for k, w in want.items():
        err = np.abs(got[k] - w)
        assert err.max() <= 2 * lr + 1e-7, (k, err.max())
        loose += int((err > 1e-7 + 2e-5 * np.abs(w)).sum())
        total += err.size
    assert loose <= loose_share * total, (loose, total)


def _assert_moments(model, opt, adam):
    have = params.adam_state_to_jax(model, opt)
    assert int(have["count"]) == int(adam.count)
    for field in ("mu", "nu"):
        ref = _flat(_np_tree(getattr(adam, field)))
        top = max(np.abs(r).max() for r in ref.values())  # the noise floor is the tree's
        for k, v in _flat(have[field]).items():
            assert np.abs(v - ref[k]).max() <= 1e-3 * np.abs(ref[k]).max() + 1e-5 * top, (field, k)


def test_synthetic_video_windows_equal_jax():
    got, want = synth.synthetic_video_windows(3, h=32, w=32, seed=4), \
        jsynth.synthetic_video_windows(3, h=32, w=32, seed=4)
    assert got[0].shape == (3, 3, 32, 32, 3) and got[1].shape == (3, 64, 64, 9)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("upscale,loss", [(2, "charbonnier"), (1, "l2")])
def test_joint_step_matches_jax(trees, upscale, loss):
    fisr, pwc = trees
    batch = _batch()
    jf, jp = jtrainer.tf_adam(LR_F), jtrainer.tf_adam(LR_P)
    jstate = jjoint.create_joint_state(fisr, pwc, jf, jp)
    jstate, want = jjoint.make_joint_train_step(jf, jp, cfg=JCFG, upscale=upscale, loss=loss,
                                                donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = _port_state(trees, train_pwc=True)
    state, got = joint.make_joint_train_step(upscale=upscale, loss=loss)(state, batch)
    assert state.step == 1 == int(jstate.step) and sorted(got) == ["joint_PSNR", "joint_loss"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-5, err_msg=k)
        assert not got[k].requires_grad
    _assert_close_trees(params.to_jax_tree(state.fisr_model), _np_tree(jstate.fisr_params), LR_F)
    _assert_close_trees(params.to_jax_tree(state.pwc_model), _np_tree(jstate.pwc_params), LR_P)
    _assert_moments(state.fisr_model, state.fisr_opt, jstate.fisr_opt[0])
    _assert_moments(state.pwc_model, state.pwc_opt, jstate.pwc_opt[0])
    # both models moved
    assert np.abs(_flat(params.to_jax_tree(state.pwc_model))[("feat", "level_1", "a", "w")]
                  - np.asarray(pwc["feat"]["level_1"]["a"]["w"])).max() > 0


def test_frozen_flow_model_matches_jax_and_leaves_fisrnet_its_gradients(trees):
    fisr, pwc = trees
    batch = _batch(n=1, seed=1)
    jf = jtrainer.tf_adam(LR_F)
    jstate = jjoint.create_joint_state(fisr, pwc, jf, None)
    jstate, want = jjoint.make_joint_train_step(jf, None, cfg=JCFG, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    step = joint.make_joint_train_step()
    frozen, got = step(_port_state(trees, train_pwc=False), batch)
    assert frozen.pwc_opt is None and jstate.pwc_opt is None and frozen.step == 1
    np.testing.assert_allclose(float(got["joint_loss"]), float(want["joint_loss"]), rtol=2e-5)
    _assert_close_trees(params.to_jax_tree(frozen.fisr_model), _np_tree(jstate.fisr_params), LR_F)
    # the flow model did not move, and holds no gradient
    for k, v in _flat(params.to_jax_tree(frozen.pwc_model)).items():
        assert np.array_equal(v, _flat(_np_tree(pwc))[k]), k
    assert all(p.grad is None for p in frozen.pwc_model.parameters())
    # FISRnet's update is the one it gets beside a training flow model
    both, _ = step(_port_state(trees, train_pwc=True), batch)
    for a, b in zip(frozen.fisr_model.parameters(), both.fisr_model.parameters()):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(frozen.pwc_model.parameters(),
                                                     both.pwc_model.parameters()))


def test_joint_loss_falls_on_one_batch(trees):
    state = _port_state(trees, train_pwc=True)
    step = joint.make_joint_train_step()
    batch = _batch(seed=2)
    losses = []
    for _ in range(5):
        state, m = step(state, batch)
        losses.append(float(m["joint_loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] and state.step == 5
    assert np.isfinite(float(m["joint_PSNR"]))


def test_dense_image_warp_gradcheck():
    """Differentiable in image and flow (f64, tiny input; the flow is kept
    off the integer grid and inside the frame, where the warp is smooth)."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.normal(size=(1, 5, 6, 2))).requires_grad_(True)
    flow = torch.from_numpy(rng.uniform(0.1, 0.9, size=(1, 5, 6, 2)) *
                            rng.choice([-1.0, 1.0], size=(1, 5, 6, 2))).requires_grad_(True)
    # keep every sample point strictly inside the frame
    with torch.no_grad():
        flow[:, 0, :, 1].abs_()
        flow[:, -1, :, 1].abs_().neg_()
        flow[:, :, 0, 0].abs_()
        flow[:, :, -1, 0].abs_().neg_()
    assert torch.autograd.gradcheck(dense_image_warp, (img, flow), eps=1e-6, atol=1e-6)
