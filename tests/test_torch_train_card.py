"""Port: the three train steps on a CUDA card against the same steps on the
CPU, and their cost-volume kernel launches. Imports the port alone (no JAX),
so it collects on a machine that has only PyTorch:

    python -m pytest tests/test_torch_train_card.py -q -m cuda

Every case is marked `cuda` and skips without a card. Sizes as in the CPU
tests (FISRnet ch=8, PWC-Net pyr_lvls=4 with search range 2, the oracle
generator's damped weights), f32 with TF32 off. cuDNN picks its own
algorithms and summation orders, so card and CPU agree to a tolerance:
metrics rtol 1e-4; parameters rtol 2e-5 / atol 1e-7 but for at most 0.5 % of
the entries, which may be up to 2*lr a step apart (Adam's first updates are
about sign(g)*lr, so an entry whose gradient is f32 noise can flip).
"""

import numpy as np
import pytest
import torch

from fisr_tpu_torch.convert import params
from fisr_tpu_torch.data import synth
from fisr_tpu_torch.kernels import cost_volume as kernel
from fisr_tpu_torch.models import pwcnet
from fisr_tpu_torch.ops.conv import Policy
from fisr_tpu_torch.train import joint, pwc_loss, pwc_trainer, trainer

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
SMALL = dict(pyr_lvls=4, flow_pred_lvl=2, search_range=2)
LR = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with torch.backends.cudnn.flags(allow_tf32=False):
        yield torch.device("cuda")


def _assert_params_track(card_model, cpu_model, n_steps, lr=LR, loose_share=0.005):
    loose = total = 0
    for (k, a), b in zip(card_model.named_parameters(), cpu_model.parameters()):
        err = (a.detach().cpu() - b.detach()).abs()
        assert float(err.max()) <= 2 * lr * n_steps + 1e-7, (k, float(err.max()))
        loose += int((err > 1e-7 + 2e-5 * b.detach().abs()).sum())
        total += err.numel()
    assert loose <= loose_share * total, (loose, total)


def _pwc_batch(seed=5):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(size=(2, 2, 64, 64, 3)).astype(np.float32),
            "y": rng.normal(size=(2, 64, 64, 2)).astype(np.float32)}


def test_train_step_on_card_matches_cpu(card):
    store = synth.synthetic_store(n_samples=6, h=32, w=32, seed=0, val_size=2)
    batch = next(store.batches(2, epoch_seed=0))
    runs = {}
    for dev in ("cpu", card):
        model = params.deterministic_fisrnet(ch=8, device=dev)
        state = trainer.TrainState(model, trainer.tf_adam(LR)(model.parameters()))
        step = trainer.make_train_step()
        for _ in range(3):
            state, m = step(state, batch)
        runs[str(dev)] = (state, {k: float(v) for k, v in m.items()})
    (cpu, m_cpu), (gpu, m_gpu) = runs["cpu"], runs[str(card)]
    assert all(p.is_cuda for p in gpu.model.parameters()) and gpu.step == 3
    for k in m_cpu:
        np.testing.assert_allclose(m_gpu[k], m_cpu[k], rtol=1e-4, err_msg=k)
    _assert_params_track(gpu.model, cpu.model, 3)


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "fma_f32"), (torch.bfloat16, "mma_bf16")])
def test_pwc_train_step_launches_the_kernel(card, dtype, variant):
    """One launch a pyramid level (3 at pyr_lvls=4) of the variant the dtype
    selects; in f32 the step agrees with the CPU's, and the gradients through
    the kernel are those through the plain version."""
    cfg = pwcnet.PWCNetConfig(**SMALL)
    batch = _pwc_batch()
    state = pwc_trainer.create_pwc_state(0, trainer.tf_adam(LR), cfg, device=card)
    before = dict(kernel.LAUNCHES_BY_VARIANT)
    state, m = pwc_trainer.make_pwc_train_step(policy=Policy(dtype))(state, batch)
    torch.cuda.synchronize()
    after = kernel.LAUNCHES_BY_VARIANT
    assert {k: after[k] - before[k] for k in after} == {v: 3 * (v == variant) for v in after}
    if dtype != torch.float32:
        assert np.isfinite(float(m["loss"]))
        return
    runs = {}
    for dev in ("cpu", card):  # on the damped weights: glorot ones leave 2 % of the entries loose
        model = params.deterministic_pwcnet(cfg, device=dev)
        st = trainer.TrainState(model, trainer.tf_adam(LR)(model.parameters()))
        runs[str(dev)] = pwc_trainer.make_pwc_train_step()(st, batch)
    (cpu, m_cpu), (gpu, m_gpu) = runs["cpu"], runs[str(card)]
    np.testing.assert_allclose(float(m_gpu["loss"]), float(m_cpu["loss"]), rtol=1e-4)
    _assert_params_track(gpu.model, cpu.model, 1)
    grads = {}
    dev_batch = trainer.batch_to_device(batch, card)
    for impl in ("kernel", "plain"):
        model = pwcnet.PWCNet(cfg, seed=1, device=card)
        _, pyr = pwcnet.apply(model, dev_batch["x"][:, 0], dev_batch["x"][:, 1],
                              pwcnet.PWCNetConfig(**SMALL, cost_volume_impl=impl))
        pwc_loss.pwcnet_loss(dev_batch["y"], pyr, list(model.parameters())).backward()
        grads[impl] = [p.grad for p in model.parameters()]
    top = max(float(g.abs().max()) for g in grads["plain"])
    for a, b in zip(grads["kernel"], grads["plain"]):
        assert float((a - b).abs().max()) <= 1e-5 * top


@pytest.mark.parametrize("train_pwc", [True, False])
def test_joint_step_launches_the_kernel(card, train_pwc):
    """Two flow calls a step, one launch a level each (6 at pyr_lvls=4),
    frozen or not; the loss agrees with the CPU step's."""
    cfg = pwcnet.PWCNetConfig(**SMALL)
    frames, target = synth.synthetic_video_windows(2, h=32, w=32, seed=0)
    batch = {"frames": frames, "target": target}
    states = {}
    for dev in ("cpu", card):
        states[str(dev)] = joint.create_joint_state(
            params.deterministic_fisrnet(ch=8, device=dev),
            params.deterministic_pwcnet(cfg, device=dev),
            trainer.tf_adam(LR), trainer.tf_adam(LR / 10) if train_pwc else None)
    _, want = joint.make_joint_train_step()(states["cpu"], batch)
    before = kernel.LAUNCHES_BY_VARIANT["fma_f32"]
    state, got = joint.make_joint_train_step()(states[str(card)], batch)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES_BY_VARIANT["fma_f32"] - before == 6 and state.step == 1
    np.testing.assert_allclose(float(got["joint_loss"]), float(want["joint_loss"]), rtol=1e-4)
    _assert_params_track(state.fisr_model, states["cpu"].fisr_model, 1)
