"""Port: the fused FISR_for_video path (pair -> window -> pipeline -> CLI)
against fisr_tpu.infer.video on the same weights and frames.

Weights are the TF-oracle generator's (damped, outputs O(1)), loaded into
both packages; FISRnet at ch=8, PWC-Net at 4 levels and d=2 for the
function-level tests and at lg-6-2 for the pipeline, as the JAX pipeline
always runs it. Measured max |diff| (f32, CPU): flows 3.9e-8 (bound 1e-4),
warps 3.1e-5 on [0, 255] values (bound 1e-3), window 1.8e-8 and fused step
1.5e-8 (bound 1e-4), pipeline frames 0 u8 counts (bound 1).
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fisr_tpu.convert.tf_import import (convert_fisrnet, convert_pwcnet,
                                        export_fisrnet, export_pwcnet)
from fisr_tpu.infer import video as jvideo
from fisr_tpu.models import fisrnet as jfisrnet
from fisr_tpu.models import pwcnet as jpwcnet
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.convert.oracle import deterministic_tf_vars
from fisr_tpu_torch.data.png_io import read_png, write_png
from fisr_tpu_torch.infer import video
from fisr_tpu_torch.models import pwcnet

torch.set_num_threads(1)
SMALL = dict(pyr_lvls=4, flow_pred_lvl=2, search_range=2)
JCFG = jpwcnet.PWCNetConfig(**SMALL, cost_volume_impl="xla")
CFG = pwcnet.PWCNetConfig(**SMALL)


def _trees(pwc_kw):
    fshapes = {n: a.shape for n, a in export_fisrnet(
        jfisrnet.init_params(jax.random.PRNGKey(0), ch=8)).items()}
    jcfg = jpwcnet.PWCNetConfig(**pwc_kw)
    pshapes = {n: a.shape for n, a in export_pwcnet(
        jpwcnet.init_params(jax.random.PRNGKey(1), jcfg),
        pyr_lvls=jcfg.pyr_lvls, flow_pred_lvl=jcfg.flow_pred_lvl).items()}
    return (convert_fisrnet(deterministic_tf_vars(fshapes)),
            convert_pwcnet(deterministic_tf_vars(pshapes), pyr_lvls=jcfg.pyr_lvls,
                           flow_pred_lvl=jcfg.flow_pred_lvl))


@pytest.fixture(scope="module")
def small_models():
    ftree, ptree = _trees(SMALL)
    return (ftree, ptree, params.fisrnet_from_jax(ftree, device="cpu"),
            params.pwcnet_from_jax(ptree, CFG, device="cpu"))


def _frames(n, h, w, seed=0):
    """Smooth pattern moving a few px a frame, YUV-as-RGB u8 [n, h, w, 3]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy = rng.uniform(0.05, 0.2, 2)
    phase = rng.uniform(0, 6.28, 3)
    out = [np.stack([127.5 + 120 * np.sin(fx * (xx - 2 * t) + fy * (yy - t) + phase[c])
                     for c in range(3)], -1) for t in range(n)]
    return np.stack(out).astype(np.uint8)


def test_pair_fn_matches_jax(small_models):
    _, ptree, _, pwc = small_models
    f = _frames(2, 32, 48).astype(np.float32)
    jfl, jwp = jvideo.make_pair_fn(JCFG)(ptree, jnp.asarray(f[:1]), jnp.asarray(f[1:]))
    fl, wp = video.make_pair_fn(CFG)(pwc, torch.from_numpy(f[:1]), torch.from_numpy(f[1:]))
    assert fl.shape == (1, 2, 32, 48, 2) and wp.shape == (1, 2, 32, 48, 3)
    np.testing.assert_allclose(fl.numpy(), np.asarray(jfl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(wp.numpy(), np.asarray(jwp), rtol=0, atol=1e-3)
    # make_flow_fn + make_warp_fn compose to the same pair
    fl2 = video.make_flow_fn(CFG)(pwc, torch.from_numpy(f[:1]), torch.from_numpy(f[1:]))
    wp2 = video.make_warp_fn()(torch.from_numpy(f[:1]), torch.from_numpy(f[1:]), fl2)
    assert torch.equal(fl2, fl) and torch.equal(wp2, wp)


def test_window_and_fused_step_match_jax(small_models):
    ftree, ptree, fisr, pwc = small_models
    f = _frames(3, 32, 32, seed=1).astype(np.float32)[None]
    jf = jnp.asarray(f)
    jpair = jvideo.make_pair_fn(JCFG)
    jp01 = jpair(ptree, jf[:, 0], jf[:, 1])
    jp12 = jpair(ptree, jf[:, 1], jf[:, 2])
    want = np.asarray(jvideo.make_fisr_window_fn()(ftree, jf, jp01, jp12))
    tf_ = torch.from_numpy(f)
    pair = video.make_pair_fn(CFG)
    p01 = pair(pwc, tf_[:, 0], tf_[:, 1])
    p12 = pair(pwc, tf_[:, 1], tf_[:, 2])
    got = video.make_fisr_window_fn()(fisr, tf_, p01, p12).numpy()
    assert got.shape == (1, 64, 64, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    step = video.make_fused_video_step(CFG)(fisr, pwc, tf_).numpy()
    want_step = np.asarray(jvideo.make_fused_video_step(JCFG)(ftree, ptree, jf))
    np.testing.assert_allclose(step, want_step, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(step, got)


@pytest.fixture(scope="module")
def full_pwc_trees():
    return _trees({})


def _write_folder(folder, n=4, h=32, w=32):
    os.makedirs(folder)
    for i, fr in enumerate(_frames(n, h, w, seed=2)):
        write_png(fr, os.path.join(folder, f"frame_{i:03d}.png"))
    return str(folder)


def test_pipeline_matches_jax_pipeline(tmp_path, full_pwc_trees):
    ftree, ptree = full_pwc_trees
    folder = _write_folder(tmp_path / "vid")
    want = jvideo.run_video_pipeline(ftree, ptree, folder, out_folder=str(tmp_path / "jax"),
                                     fused=True, verbose=False)
    fisr = params.fisrnet_from_jax(ftree, device="cpu")
    pwc = params.pwcnet_from_jax(ptree, device="cpu")
    got = video.run_video_pipeline(fisr, pwc, folder, out_folder=str(tmp_path / "port"),
                                   fused=True, verbose=False, device="cpu")
    assert len(got) == len(want) == 6
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    names = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "jax" / "*.png")))
    assert len(names) == 10  # 5 output frames, RGB and YUV
    for name in names:
        a = read_png(tmp_path / "port" / name).astype(np.int16)
        b = read_png(tmp_path / "jax" / name).astype(np.int16)
        assert a.shape == (64, 64, 3)
        assert np.abs(a - b).max() <= 1, name


def test_pipeline_staged_path_is_not_ported(small_models, tmp_path):
    _, _, fisr, pwc = small_models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        video.run_video_pipeline(fisr, pwc, str(tmp_path), device="cpu")


def test_cli_video_phase(tmp_path, full_pwc_trees):
    from fisr_tpu_torch.cli.main import main

    ftree, ptree = full_pwc_trees
    folder = _write_folder(tmp_path / "vid", n=3)
    for name, tree in (("fisr.npz", ftree), ("pwc.npz", ptree)):
        flat = {"/".join(k.key for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(tree)}
        np.savez(tmp_path / name, **flat)
    base = ["--phase", "FISR_for_video", "--frame_folder_path", folder, "--frame_num", "3",
            "--video_out_dir", str(tmp_path / "out"), "--device", "cpu",
            "--compute_dtype", "float32"]
    out = main(base + ["--fused", "--fisr_params_npz", str(tmp_path / "fisr.npz"),
                       "--pwc_params_npz", str(tmp_path / "pwc.npz")])
    assert len(out) == 3 and all(os.path.exists(p) for p in out)
    assert read_png(out[0]).shape == (64, 64, 3)
    with pytest.raises(SystemExit, match="weights"):
        main(base + ["--fused"])
    with pytest.raises(NotImplementedError):
        main(base)
    with pytest.raises(NotImplementedError):
        main(base + ["--fused", "--phase", "test"])
