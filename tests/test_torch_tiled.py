"""Port: host-staged patch tiling (infer/tiled.py) and the .flo / .mat files
against the JAX package and the TF-oracle fixtures of the reference's own
run.

FISRnet at ch=8 on the oracle generator's damped weights for the JAX
comparisons (bound 1e-4), at full width for the oracle pins, f32, one
thread. Measured max |diff| (CPU): TiledRunner exact 2.4e-8 and padded
2.3e-8 against JAX; exact (1, 2) against the reference's stitch 3.0e-8
(bound 1e-6, as tests/test_video_oracle.py); device tiling (1, 2) against
the reference's stitch 1.33e-2 at the frame edge and 1.1e-6 inside (bounds
0.05 and 2e-3, as there), full frame 4.6e-7 (bound 1e-5); .flo and .mat
round trips bit-exact both ways.
"""

import os

import numpy as np
import pytest
import torch

import jax

from fisr_tpu.data import flo as jflo
from fisr_tpu.data import matio as jmatio
from fisr_tpu.infer import tiled as jtiled
from fisr_tpu.models import fisrnet as jfisrnet
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.convert.oracle import deterministic_tf_vars
from fisr_tpu_torch.data import flo, matio
from fisr_tpu_torch.infer import tiled, video

torch.set_num_threads(1)
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "tf_oracle")
FLOW_NORM = 96.0 * 2.0


@pytest.fixture(scope="module")
def small():
    """(JAX tree, port model) of one ch=8 FISRnet on damped weights."""
    from fisr_tpu.convert.tf_import import convert_fisrnet, export_fisrnet

    shapes = {n: a.shape for n, a in export_fisrnet(
        jfisrnet.init_params(jax.random.PRNGKey(0), ch=8)).items()}
    tree = convert_fisrnet(deterministic_tf_vars(shapes))
    return tree, params.fisrnet_from_jax(tree, device="cpu")


@pytest.fixture(scope="module")
def full_model():
    return params.deterministic_fisrnet(device="cpu")


@pytest.fixture(scope="module")
def oracle():
    return np.load(os.path.join(FIX, "video_pipeline.npz"))


def _inp(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, size=shape).astype(np.float32)


@pytest.mark.parametrize("grid", [(1, 1), (1, 2), (2, 2), (2, 3), (3, 2), (4, 6)])
def test_boundary_math_matches_jax(grid):
    gh, gw = grid
    rng = np.random.default_rng(gh * 10 + gw)
    for h, w, boundary in ((32 * gh, 32 * gw, 32), (64 * gh, 96 * gw, 32), (48 * gh, 40 * gw, 16),
                           (64 * gh, 64 * gw, 0)):
        s_h, s_w = h // gh, w // gw
        for p_h in range(gh):
            for p_w in range(gw):
                args = (boundary, h, w, p_h, s_h, p_w, s_w)
                got = tiled.get_hw_boundary(*args)
                assert got == jtiled.get_hw_boundary(*args)
                hl, hh, wl, wh, _, _ = got
                img = rng.normal(size=(1, (hh - hl) * 2, (wh - wl) * 2, 2)).astype(np.float32)
                a = tiled.trim_patch_boundary(img, *args, 2)
                b = jtiled.trim_patch_boundary(img, *args, 2)
                np.testing.assert_array_equal(a, b)
                assert a.shape == (1, s_h * 2, s_w * 2, 2)


@pytest.mark.parametrize("mode,grid,hw", [("exact", (1, 3), (64, 192)),
                                          ("padded", (2, 2), (64, 128))])
def test_tiled_runner_matches_jax(small, mode, grid, hw):
    """(1, 3) has two halo signatures (edge and interior patches), so the
    grouping runs; (2, 2) splits both axes."""
    tree, model = small
    inp = _inp(1, (2, *hw, 29))
    want = jtiled.TiledRunner(tree, grid=grid, boundary=32, mode=mode)(inp)
    got = tiled.TiledRunner(model, grid=grid, boundary=32, mode=mode, device="cpu")(inp)
    assert got.shape == want.shape == (2, hw[0] * 2, hw[1] * 2, 9) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_tiled_runner_rejects_thin_patches_and_unknown_modes(small):
    _, model = small
    runner = tiled.TiledRunner(model, grid=(2, 2), boundary=32, device="cpu")
    with pytest.raises(ValueError, match="boundary"):
        runner(np.zeros((1, 32, 128, 29), np.float32))
    with pytest.raises(ValueError, match="mode"):
        tiled.TiledRunner(model, mode="fast", device="cpu")


def test_tiled_runner_defaults_to_the_card(small, monkeypatch):
    _, model = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tiled.TiledRunner(model)


def _window_input(z, fr):
    frames = z["frames"].astype(np.float32)
    h, w = frames.shape[1], frames.shape[2]
    flows, warps = z["flows_amp"], z["warps_amp_norm"]
    img = np.clip(frames[fr:fr + 3].transpose(1, 2, 0, 3).reshape(h, w, 9) / 255.0, 0, 1)
    fl = np.concatenate([flows[fr], flows[fr + 1]], 0).transpose(1, 2, 0, 3).reshape(h, w, 8)
    wp = np.concatenate([warps[fr], warps[fr + 1]], 0).transpose(1, 2, 0, 3).reshape(h, w, 12)
    return np.concatenate([img, np.clip(fl / FLOW_NORM, -1, 1), np.clip(wp, 0, 1)],
                          2).astype(np.float32)[None]


@pytest.mark.parametrize("fr", [0, 1])
def test_tiled_runner_exact_matches_reference_stitch(full_model, oracle, fr):
    """TiledRunner(mode='exact') against the reference's own patch loop
    (get_HW_boundary / trim_patch_boundary, amplified-flow chain)."""
    runner = tiled.TiledRunner(full_model, grid=(1, 2), boundary=32, mode="exact", device="cpu")
    pred = np.clip(runner(_window_input(oracle, fr))[0], 0, 1)
    np.testing.assert_allclose(pred, oracle["stitched_amp"][fr], rtol=0, atol=1e-6)


def test_device_tiling_deviation_from_reference_stitch_is_bounded(full_model, oracle):
    """The window stage under fisr_grid=(1, 2) (device tiling: zero ring at
    the outer edge, folded upsample) against the reference's stitch: the
    same bounds as the JAX package holds."""
    z = oracle
    frames = torch.from_numpy(z["frames"].astype(np.float32))
    pair = [(torch.from_numpy(z["flows_amp"][i:i + 1]),
             torch.from_numpy(z["warps_amp_norm"][i:i + 1] * 255.0)) for i in (0, 1)]
    pred = video.make_fisr_window_fn(fisr_grid=(1, 2))(full_model, frames[None, 0:3], *pair)[0]
    d = np.abs(pred.numpy() - z["stitched_amp"][0])
    assert d.max() < 0.05, d.max()
    assert d[48:-48, 48:-48].max() < 2e-3, d[48:-48, 48:-48].max()
    # full frame: at this size the reference's halo covers the whole extent
    full = video.make_fisr_window_fn()(full_model, frames[None, 0:3], *pair)[0]
    np.testing.assert_allclose(full.numpy(), z["stitched_amp"][0], rtol=0, atol=1e-5)


def test_flo_reader_reads_reference_written_bytes(oracle):
    got = flo.read_flo_5dim(os.path.join(FIX, "video_ref.flo"))
    np.testing.assert_array_equal(got, oracle["flows"])
    with pytest.raises(ValueError, match="magic"):
        flo.read_flo_5dim(os.path.join(FIX, "video_manifest.json"))


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_flo_and_mat_files_cross_read_bit_exact(tmp_path, writer, reader):
    rng = np.random.default_rng(3)
    w_flo, w_mat = (flo, matio) if writer == "port" else (jflo, jmatio)
    r_flo, r_mat = (flo, matio) if reader == "port" else (jflo, jmatio)
    flows = rng.normal(size=(2, 3, 6, 9, 2)).astype(np.float32)
    w_flo.write_flo_5dim(flows, tmp_path / "a.flo")
    np.testing.assert_array_equal(r_flo.read_flo_5dim(tmp_path / "a.flo"), flows)
    one = rng.normal(size=(5, 7, 2)).astype(np.float32)
    w_flo.write_flo(one, tmp_path / "b.flo")
    np.testing.assert_array_equal(r_flo.read_flo(tmp_path / "b.flo"), one)
    warps = rng.uniform(0, 255, size=(2, 4, 6, 9, 3)).astype(np.float32)
    w_mat.write_warp_mat(warps, tmp_path / "w.mat")
    np.testing.assert_array_equal(r_mat.read_warp_mat(tmp_path / "w.mat"), warps / np.float32(255))
    train = rng.integers(0, 256, size=(2, 5, 6, 9, 3)).astype(np.float32)
    w_mat.write_train_mat(tmp_path / "t.mat", "LR_data", train)
    np.testing.assert_array_equal(r_mat.read_train_mat(tmp_path / "t.mat", "LR_data"),
                                  train / np.float32(255))
    with pytest.raises(ValueError):
        flo.write_flo_5dim(one, tmp_path / "bad.flo")
