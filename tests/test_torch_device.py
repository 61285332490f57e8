"""Port: device-resident tiling (infer/device.py), its planning functions
and the CLI's grid grammar against the JAX package.

FISRnet at ch=8 on the oracle generator's damped weights, f32, one thread;
bound 1e-4 against JAX. Measured max |diff| (CPU): tiled_apply 1.5e-8,
tiled_apply_padded 1.5e-8, staged_apply 3.7e-8 at most a level,
run_level_tiled 3.0e-8, runners full 1.5e-8 / staged 2.6e-8 / tiled 1.5e-8,
FastTiledRunner 1.9e-8; tiled_apply against the port's own
TiledRunner(mode='padded') 1.9e-8 (bound 1e-5: the shrink and the folded
upsample leave the retained pixels alone). The
planning functions are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fisr_tpu.cli import _common as jcommon
from fisr_tpu.infer import device as jdevice
from fisr_tpu.infer import video as jvideo
from fisr_tpu.models import fisrnet as jfisrnet
from fisr_tpu.ops.conv import F32 as JF32
from fisr_tpu_torch.cli import _common as common
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.convert.oracle import deterministic_tf_vars
from fisr_tpu_torch.infer import device, tiled, video
from fisr_tpu_torch.models import fisrnet
from fisr_tpu_torch.ops.conv import F32

torch.set_num_threads(1)
SIZES = [(32, 32), (64, 128), (256, 448), (512, 960), (544, 960), (736, 1280), (1024, 1920),
         (1056, 1920), (1088, 1920), (2144, 3840), (2176, 4096)]


@pytest.fixture(scope="module")
def small():
    from fisr_tpu.convert.tf_import import convert_fisrnet, export_fisrnet

    shapes = {n: a.shape for n, a in export_fisrnet(
        jfisrnet.init_params(jax.random.PRNGKey(0), ch=8)).items()}
    tree = convert_fisrnet(deterministic_tf_vars(shapes))
    return tree, params.fisrnet_from_jax(tree, device="cpu")


def _inp(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, size=shape).astype(np.float32)


def _close(got, want, atol=1e-4):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("hw", SIZES)
def test_plans_match_jax(hw):
    h, w = hw
    assert device.padded_grid(h, w) == jdevice.padded_grid(h, w)
    assert device.padded_grid(h, w, (6, 6), 0.125) == jdevice.padded_grid(h, w, (6, 6), 0.125)
    assert device.best_grid(h, w) == jdevice.best_grid(h, w)
    assert device.best_grid(h, w, (2, 3)) == jdevice.best_grid(h, w, (2, 3))
    assert device.default_plans(h, w) == jdevice.default_plans(h, w)
    for spec in ("auto", (2, 2), [1, 3]):
        assert video.resolve_fisr_plan(spec, h, w, F32) == jvideo.resolve_fisr_plan(spec, h, w, JF32)


def test_plans_at_the_video_sizes_and_their_errors(tmp_path, monkeypatch):
    assert device.padded_grid(1024, 1920) == ((4, 6), (0, 0))
    assert device.padded_grid(1056, 1920) == ((4, 6), (96, 0))
    assert device.best_grid(1056, 1920) == (3, 6)
    for fn in (device.padded_grid, device.best_grid):
        with pytest.raises(ValueError, match="32-multiples"):
            fn(1080, 1920)
    # 'tuned' where this size was never tuned: the heuristic, as in JAX
    from fisr_tpu_torch.infer import autotune

    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH", str(tmp_path / "none.json"))
    assert video.resolve_fisr_plan("tuned", 1056, 1920, F32, device="cpu") == ((4, 6), (96, 0))


@pytest.mark.parametrize("spec", ["full", "auto", "tuned", "2,2", "4,6", "1, 3"])
def test_parse_grid_matches_jax(spec):
    assert common.parse_grid(spec) == jcommon.parse_grid(spec)


def test_parse_grid_rejects_other_words():
    for bad in ("fast", "2", "2,2,2"):
        with pytest.raises(ValueError):
            common.parse_grid(bad)


@pytest.mark.parametrize("grid", [(2, 2), (1, 2)])
def test_tiled_apply_matches_jax_and_host_padded_tiling(small, grid):
    """(2, 2) shrinks the stale halo; (1, 2) splits one axis and does not.
    Only (2, 2) is held against the host tiling: with an unsplit axis the
    folded upsample meets the true canvas border, where it is documented to
    differ from the composition (measured 6.1e-4)."""
    tree, model = small
    x = _inp(1, (1, 64, 128, 29))
    want = jax.jit(lambda p, t: jdevice.tiled_apply(p, t, grid, 32))(tree, jnp.asarray(x))
    with torch.no_grad():
        got = device.tiled_apply(model, torch.from_numpy(x), grid, 32)
    _close(got, want)
    if grid == (2, 2):
        host = tiled.TiledRunner(model, grid=grid, boundary=32, mode="padded", device="cpu")(x)
        _close(got, host, atol=1e-5)


def test_tiled_apply_padded_matches_jax(small):
    tree, model = small
    x = _inp(2, (1, 64, 96, 29))
    want = jax.jit(lambda p, t: jdevice.tiled_apply_padded(p, t, (2, 2), (0, 32), 32))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        got = device.tiled_apply_padded(model, torch.from_numpy(x), (2, 2), (0, 32), 32)
        same = device.tiled_apply_padded(model, torch.from_numpy(x), (2, 3), (0, 0), 32)
        plain = device.tiled_apply(model, torch.from_numpy(x), (2, 3), 32)
    assert got.shape == (1, 128, 192, 9)
    _close(got, want)
    assert torch.equal(same, plain)
    with pytest.raises(ValueError, match="divide"):
        device.tiled_apply(model, torch.from_numpy(x), (3, 2), 32)


def test_staged_apply_and_run_level_tiled_match_jax(small):
    tree, model = small
    x = _inp(3, (1, 64, 128, 29))
    plans = {"level_1": (1, 1), "level_2": (1, 2), "level_3": (2, 2)}
    want = jax.jit(lambda p, t: jdevice.staged_apply(p, t, plans, 32))(tree, jnp.asarray(x))
    with torch.no_grad():
        got = device.staged_apply(model, torch.from_numpy(x), plans, 32)
        full = device.staged_apply(model, torch.from_numpy(x))  # default plans: all (1, 1) here
        ref = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        _close(g, w)
    for g, r in zip(full, ref):
        assert torch.equal(g, r)
    x38 = _inp(4, (1, 64, 128, 38))
    want = jax.jit(lambda p, t: jdevice.run_level_tiled(p, t, (2, 2), 32))(
        tree["level_3"], jnp.asarray(x38))
    with torch.no_grad():
        got = device.run_level_tiled(model.level_3, torch.from_numpy(x38), (2, 2), 32)
    _close(got, want)


@pytest.mark.parametrize("mode", ["full", "staged", "tiled"])
def test_device_runner_matches_jax(small, mode):
    tree, model = small
    x = _inp(5, (1, 64, 128, 29))
    want = jdevice.make_device_runner(mode, grid=(2, 2))(tree, jnp.asarray(x))
    run = device.make_device_runner(mode, grid=(2, 2))
    got = run(model, torch.from_numpy(x))
    assert not got.requires_grad
    _close(got, want)


def test_full_runner_is_the_full_frame_window(small):
    """make_device_runner('full') (the tuner's (1, 1) candidate, the
    multi-device runner) runs the very FISRnet call of the video path's
    full-frame window: one input path, equal bit for bit."""
    _tree, model = small
    x = torch.from_numpy(_inp(6, (1, 64, 128, 29)))
    got = device.make_device_runner("full")(model, x)
    with torch.no_grad():
        want = fisrnet.apply(model, x)[2]
    assert torch.equal(got, want)


def test_device_runner_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        device.make_device_runner("exact")


def test_fast_tiled_runner_matches_jax(small, monkeypatch):
    tree, model = small
    x = _inp(6, (2, 64, 128, 29))
    want = jdevice.FastTiledRunner(tree, grid=(2, 2))(x)
    runner = device.FastTiledRunner(model, grid=(2, 2), device="cpu")
    got = runner(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert (runner.grid, runner.sf) == ((2, 2), 2)
    _close(got, want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        device.FastTiledRunner(model)


# ---- the numeric policy of the entry points (fisr_tpu_torch/device.py) ------------------
#
# Each entry point below runs its work through an inner call that is replaced
# here by one that records the three backend flags. TF32 is forced on and
# cuDNN's deterministic mode off beforehand (PyTorch's defaults on a card), so
# an entry point that leaves them alone is seen to.

from fisr_tpu_torch import device as policy  # noqa: E402
from fisr_tpu_torch.ops.conv import BF16  # noqa: E402

DEFAULTS = (True, True, False)  # cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
EXACT = (False, False, False)


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)


@pytest.fixture
def card_defaults(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    assert _flags() == DEFAULTS


def test_exact_f32_sets_and_restores_both_flags(card_defaults):
    with policy.exact_f32():
        assert _flags() == EXACT
        with policy.exact_f32(), policy.cudnn_deterministic():
            assert _flags() == (False, False, True)
        assert _flags() == EXACT  # the inner scope leaves the outer one's setting
    assert _flags() == DEFAULTS
    with pytest.raises(KeyError):
        with policy.exact_f32():
            raise KeyError("a failure inside the block")
    assert _flags() == DEFAULTS
    with policy.f32_scope(BF16):
        assert _flags() == DEFAULTS
    with policy.f32_scope(F32):
        assert _flags() == EXACT
    assert _flags() == DEFAULTS


def test_exact_f32_holds_until_the_last_thread_leaves(card_defaults):
    """Two services of one process on two cards: the one that leaves first
    must not turn TF32 back on under the other."""
    import threading

    inside, release, seen = threading.Event(), threading.Event(), []

    def other():
        with policy.exact_f32():
            inside.set()
            release.wait(10)
            seen.append(_flags())

    t = threading.Thread(target=other)
    with policy.exact_f32():
        t.start()
        assert inside.wait(10)
    assert _flags() == EXACT  # the other thread is still inside
    release.set()
    t.join(10)
    assert seen == [EXACT] and _flags() == DEFAULTS


@pytest.mark.parametrize("dtype,want", [("float32", EXACT), ("bfloat16", DEFAULTS)])
@pytest.mark.parametrize("phase", ["test", "FISR_for_video", "train"])
def test_main_cli_runs_an_f32_phase_without_tf32(card_defaults, monkeypatch, dtype, want,
                                                 phase):
    from fisr_tpu_torch.cli import main as cli

    seen = []
    for name in ("run_train", "run_test", "run_video"):
        monkeypatch.setattr(cli, name, lambda args, dev, name=name: seen.append((name, _flags())))
    cli.main(["--phase", phase, "--device", "cpu", "--compute_dtype", dtype])
    runs = {"test": ["run_test"], "FISR_for_video": ["run_video"],
            "train": ["run_train", "run_test"]}[phase]
    assert seen == [(name, want) for name in runs]
    assert _flags() == DEFAULTS


@pytest.mark.parametrize("pol,want", [(F32, EXACT), (BF16, DEFAULTS)])
def test_fit_runs_an_f32_policy_without_tf32(card_defaults, monkeypatch, tmp_path, pol, want):
    from fisr_tpu_torch.data import synth
    from fisr_tpu_torch.train import loop, trainer

    seen = []

    def make_step(loss_weights, policy_, mesh=None):
        def step(state, batch):
            seen.append(("train", _flags()))
            return state, {"total_loss": torch.tensor(1.0), "train_PSNR": torch.tensor(20.0)}
        return step

    def make_val(policy_):
        def val(model, batch):
            seen.append(("val", _flags()))
            return {"val_PSNR": torch.tensor(20.0), "val_recnLoss": torch.tensor(1.0)}
        return val

    monkeypatch.setattr(loop, "make_train_step", make_step)
    monkeypatch.setattr(loop, "make_val_step", make_val)
    monkeypatch.setattr(loop, "create_state", lambda seed, opt, device: trainer.create_state(
        seed, opt, ch=8, device=device))
    store = synth.synthetic_store(n_samples=6, h=16, w=16, seed=0, val_size=2)
    state = loop.fit(store, ckpt_dir=str(tmp_path / "ck"), epochs=1, batch_size=2,
                     policy=pol, device="cpu")
    assert state.step == 0  # the recording step leaves the state as it was
    assert seen == [("train", want)] * 2 + [("val", want)]
    assert _flags() == DEFAULTS


@pytest.mark.parametrize("pol,want", [(F32, EXACT), (BF16, DEFAULTS)])
def test_pwc_fit_runs_an_f32_policy_without_tf32(card_defaults, monkeypatch, tmp_path, pol,
                                                 want):
    from fisr_tpu_torch.data.flow_dataset import FlowDataset
    from fisr_tpu_torch.train import pwc_trainer

    seen = []

    def make_step(cfg, policy_, loss_mode):
        def step(state, batch):
            seen.append(("train", _flags()))
            return state, {"loss": torch.tensor(1.0)}
        return step

    def make_eval(cfg, policy_):
        def evaluate(model, batch):
            seen.append(("eval", _flags()))
            return {"epe": torch.tensor(1.0)}
        return evaluate

    class NoSave:
        def __init__(self, *a, **kw):
            pass

        def save(self, *a, **kw):
            seen.append(("save", _flags()))

    monkeypatch.setattr(pwc_trainer, "make_pwc_train_step", make_step)
    monkeypatch.setattr(pwc_trainer, "make_pwc_eval_step", make_eval)
    monkeypatch.setattr(pwc_trainer, "CheckpointManager", NoSave)
    ds = FlowDataset.synthetic_textured(n=4, h=32, w=32, seed=0, val_split=0.5)
    pwc_trainer.pwc_fit(ds, str(tmp_path / "ck"), steps=2, batch_size=2, val_every=2,
                        policy=pol, device="cpu")
    assert seen == [("train", want)] * 2 + [("eval", want), ("save", want)]
    assert _flags() == DEFAULTS


@pytest.mark.parametrize("pol,want", [(F32, EXACT), (BF16, DEFAULTS)])
def test_service_computes_an_f32_policy_without_tf32(card_defaults, pol, want):
    """FISRService sets the flags under its lock around each device call."""
    from fisr_tpu_torch.infer.daemon import FISRService
    from fisr_tpu_torch.models.fisrnet import FISRnet
    from fisr_tpu_torch.models.pwcnet import PWCNet

    h, w = 32, 64
    svc = FISRService(FISRnet(ch=8, device="cpu"), PWCNet(device="cpu"), h, w, policy=pol,
                      device="cpu", warmup=False)
    seen = []

    def record(*args):
        seen.append(_flags())
        return torch.zeros((1, 2 * h, 2 * w, 9))

    svc._window_step = svc._win_fn = record
    svc._pair_fn = lambda *args: (seen.append(_flags()), "pair")[1]
    frame = np.zeros((h, w, 3), np.uint8)
    assert len(svc.window([frame] * 3)) == 3
    for _ in range(3):
        svc.stream_frame("s", frame)
    # the window, then the stream's pairs (frames 2 and 3) and its one window
    assert seen == [want] * 4
    assert _flags() == DEFAULTS
