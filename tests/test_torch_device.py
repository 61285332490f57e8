"""Port: device-resident tiling (infer/device.py), its planning functions
and the CLI's grid grammar against the JAX package.

FISRnet at ch=8 on the oracle generator's damped weights, f32, one thread;
bound 1e-4 against JAX. Measured max |diff| (CPU): tiled_apply 1.5e-8,
tiled_apply_padded 1.5e-8, staged_apply 3.7e-8 at most a level,
run_level_tiled 3.0e-8, runners full 1.5e-8 / staged 2.6e-8 / tiled 1.5e-8,
FastTiledRunner 1.9e-8; tiled_apply against the port's own
TiledRunner(mode='padded') 1.9e-8 (bound 1e-5: the shrink, the folded
upsample and the fused glue all leave the retained pixels alone). The
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
        assert video.resolve_fisr_grid(spec, h, w, F32) == jvideo.resolve_fisr_grid(spec, h, w, JF32)


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
    assert video.resolve_fisr_grid("tuned", 1056, 1920, F32, device="cpu") == (3, 6)


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
