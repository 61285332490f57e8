"""Port: the FISR_for_video paths, fused and staged (pair -> window ->
pipeline -> CLI), against fisr_tpu.infer.video on the same weights and frames.

Weights are the TF-oracle generator's (damped, outputs O(1)), loaded into
both packages; FISRnet at ch=8, PWC-Net at 4 levels and d=2 for the
function-level tests and at lg-6-2 for the pipeline, as the JAX pipeline
always runs it. Measured max |diff| (f32, CPU): flows 3.9e-8 (bound 1e-4),
warps 3.1e-5 on [0, 255] values (bound 1e-3), window 1.8e-8 and fused step
1.5e-8 (bound 1e-4), pipeline frames 0 u8 counts (bound 1), fused and
staged; the window under fisr_grid (1, 2) and 'auto' 1.4e-8 (bound 1e-4); the
staged path's .flo 6.1e-8 px and .mat 2.1e-7 (of [0, 1]) against the JAX
pipeline's files. The pipeline's frames through the host runtime
(fisr_tpu_torch/native) and through its plain versions: bit-equal.

The JAX fused loop writes window k's third frame and window k+1's first to
the same two files from two of its four writer threads at once, so which of
the two lands is a race (one md5 in six differed under load). Its pipeline
runs here with one writer thread: the writes land in submission order and the
later one wins, as in its serial loop and in the port.
"""

import concurrent.futures
import glob
import os
from concurrent.futures.thread import ThreadPoolExecutor

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
from fisr_tpu_torch import native
from fisr_tpu_torch.data import flo, matio, png_io
from fisr_tpu_torch.data.png_io import read_png, write_png
from fisr_tpu_torch.infer import video
from fisr_tpu_torch.models import pwcnet
from fisr_tpu_torch.ops import color

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


@pytest.mark.parametrize("fisr_grid", [(1, 2), "auto"])
def test_window_under_fisr_grid_matches_jax(small_models, fisr_grid):
    """The window stage through the device tiling: an explicit grid, and
    'auto' (at 64x128 the plan is (2, 4), pad (0, 0))."""
    ftree, _, fisr, _ = small_models
    rng = np.random.default_rng(5)
    f = _frames(3, 64, 128, seed=3).astype(np.float32)[None]
    pairs = [(rng.normal(scale=4.0, size=(1, 2, 64, 128, 2)).astype(np.float32),
              rng.uniform(0, 255, size=(1, 2, 64, 128, 3)).astype(np.float32)) for _ in range(2)]
    want = np.asarray(jvideo.make_fisr_window_fn(fisr_grid=fisr_grid)(
        ftree, jnp.asarray(f), *[tuple(jnp.asarray(t) for t in p) for p in pairs]))
    got = video.make_fisr_window_fn(fisr_grid=fisr_grid)(
        fisr, torch.from_numpy(f), *[tuple(torch.from_numpy(t) for t in p) for p in pairs])
    assert got.shape == (1, 128, 256, 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert 0.0 <= got.min() and got.max() <= 1.0


@pytest.fixture(scope="module")
def full_pwc_trees():
    return _trees({})


def _write_folder(folder, n=4, h=32, w=32):
    os.makedirs(folder, exist_ok=True)
    for i, fr in enumerate(_frames(n, h, w, seed=2)):
        write_png(fr, os.path.join(folder, f"frame_{i:03d}.png"))
    return str(folder)


def _one_writer_thread(*args, **kwargs):
    return ThreadPoolExecutor(max_workers=1)


def test_pipeline_matches_jax_pipeline(tmp_path, full_pwc_trees, monkeypatch):
    ftree, ptree = full_pwc_trees
    folder = _write_folder(tmp_path / "vid")
    with monkeypatch.context() as m:  # the JAX writers' race (module docstring)
        m.setattr(concurrent.futures, "ThreadPoolExecutor", _one_writer_thread)
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
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        a = read_png(tmp_path / "port" / name).astype(np.int16)
        b = read_png(tmp_path / "jax" / name).astype(np.int16)
        assert a.shape == (64, 64, 3)
        assert np.abs(a - b).max() <= 1, name


def test_pipeline_frames_through_the_host_runtime_equal_its_plain_versions(
        tmp_path, full_pwc_trees, monkeypatch):
    """The fused pipeline with its host stages on the host runtime (threaded
    decode, colour with ops/color's constants, threaded encode) and on their
    plain versions (read_png, ops/color.yuv2rgb_matlab_u8, png_io.encode_png,
    the parent's route): the same files, pixel for pixel."""
    ftree, ptree = full_pwc_trees
    folder = _write_folder(tmp_path / "vid")
    fisr = params.fisrnet_from_jax(ftree, device="cpu")
    pwc = params.pwcnet_from_jax(ptree, device="cpu")
    kw = dict(fused=True, verbose=False, device="cpu")
    video.run_video_pipeline(fisr, pwc, folder, out_folder=str(tmp_path / "native"), **kw)
    plain = native.plain_versions()
    with monkeypatch.context() as m:
        m.setattr(video, "decode_png_batch", plain["decode_png_batch"])
        m.setattr(video, "yuv2rgb_ops_u8", color.yuv2rgb_matlab_u8)
        m.setattr(video, "encode_png_bytes", png_io.encode_png)
        video.run_video_pipeline(fisr, pwc, folder, out_folder=str(tmp_path / "plain"), **kw)
    names = sorted(os.listdir(tmp_path / "plain"))
    assert len(names) == 10 and names == sorted(os.listdir(tmp_path / "native"))
    for name in names:
        np.testing.assert_array_equal(read_png(tmp_path / "native" / name),
                                      read_png(tmp_path / "plain" / name), err_msg=name)


def test_staged_pipeline_matches_jax_pipeline(tmp_path, full_pwc_trees):
    """fused=False: flows and warps to the host and to .flo / .mat, then
    TiledRunner(grid=(1, 2), 'exact'); frames, file order and artifacts
    against the JAX pipeline's. The 40x72 frames are cropped to 32x64."""
    ftree, ptree = full_pwc_trees
    fisr = params.fisrnet_from_jax(ftree, device="cpu")
    pwc = params.pwcnet_from_jax(ptree, device="cpu")
    out = {}
    for side in ("jax", "port"):
        folder = _write_folder(tmp_path / side / "scene7", n=4, h=40, w=72)
        kw = dict(out_folder=str(tmp_path / side / "out"), grid=(1, 2), boundary=32,
                  write_artifacts=True, verbose=False)
        if side == "jax":
            out[side] = jvideo.run_video_pipeline(ftree, ptree, folder, **kw)
        else:
            out[side] = video.run_video_pipeline(fisr, pwc, folder, device="cpu", **kw)
    assert [os.path.basename(p) for p in out["port"]] == [os.path.basename(p) for p in out["jax"]]
    assert len(out["port"]) == 6
    names = sorted(os.listdir(tmp_path / "jax" / "out"))
    assert names == sorted(os.listdir(tmp_path / "port" / "out")) and len(names) == 10
    for name in names:
        a = read_png(tmp_path / "port" / "out" / name).astype(np.int16)
        b = read_png(tmp_path / "jax" / "out" / name).astype(np.int16)
        assert a.shape == (64, 128, 3)
        assert np.abs(a - b).max() <= 1, name
    fl = [flo.read_flo_5dim(tmp_path / side / "scene7" / "scene7_test_ss1_fr4.flo")
          for side in ("port", "jax")]
    wp = [matio.read_warp_mat(tmp_path / side / "scene7" / "scene7_ss1_fr4_warp.mat")
          for side in ("port", "jax")]
    assert fl[0].shape == (3, 2, 40, 72, 2) and wp[0].shape == (3, 2, 40, 72, 3)
    np.testing.assert_allclose(fl[0], fl[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(wp[0], wp[1], rtol=0, atol=1e-3 / 255)


def test_pipeline_staged_path_is_not_ported(small_models, tmp_path, monkeypatch):
    """The 'tuned' plan reads the autotune cache: with this size never tuned
    the fused pipeline runs the 'auto' plan (the same frames), with a tuned
    entry it runs that entry's plan; fewer than 3 frames raise."""
    from fisr_tpu_torch.infer import autotune

    _, _, fisr, pwc = small_models
    folder = _write_folder(tmp_path / "vid", n=3, h=32, w=64)
    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH", str(tmp_path / "tune.json"))

    def run(tag, spec):
        out = video.run_video_pipeline(fisr, pwc, folder, out_folder=str(tmp_path / tag),
                                       fused=True, fisr_grid=spec, device="cpu", verbose=False)
        return np.stack([read_png(p) for p in out])

    np.testing.assert_array_equal(run("tuned", "tuned"), run("auto", "auto"))
    autotune.TuneCache(device="cpu").tune(fisr, 32, 64, reps=1)
    grid, pads = autotune.TuneCache(device="cpu").best_plan(32, 64, "float32")
    assert pads == (0, 0)
    np.testing.assert_array_equal(run("tuned2", "tuned"), run("grid", grid))
    with pytest.raises(ValueError, match="3 frames"):
        video.run_video_pipeline(fisr, pwc, str(tmp_path), device="cpu")


def test_cli_video_phase(tmp_path, full_pwc_trees, monkeypatch):
    from fisr_tpu_torch.cli.main import main
    from fisr_tpu_torch.infer import autotune

    ftree, ptree = full_pwc_trees
    folder = _write_folder(tmp_path / "vid", n=3, h=32, w=64)
    for name, tree in (("fisr.npz", ftree), ("pwc.npz", ptree)):
        flat = {"/".join(k.key for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(tree)}
        np.savez(tmp_path / name, **flat)
    base = ["--phase", "FISR_for_video", "--frame_folder_path", folder, "--frame_num", "3",
            "--device", "cpu", "--compute_dtype", "float32"]
    weights = ["--fisr_params_npz", str(tmp_path / "fisr.npz"),
               "--pwc_params_npz", str(tmp_path / "pwc.npz")]

    def run(tag, *flags):
        out = main(base + weights + ["--video_out_dir", str(tmp_path / tag)] + list(flags))
        assert len(out) == 3 and all(os.path.exists(p) for p in out)
        return np.stack([read_png(p) for p in out]).astype(np.int16)

    fused = run("fused", "--fused")
    assert fused.shape == (3, 64, 128, 3)
    # the staged path (no --fused) writes the artifacts beside the frames
    staged = run("staged", "--FISR_test_patch", "1", "2")
    assert os.path.exists(os.path.join(folder, "vid_test_ss1_fr3.flo"))
    assert os.path.exists(os.path.join(folder, "vid_ss1_fr3_warp.mat"))
    # at this size the 32-px halo covers the frame: exact tiling == full frame
    assert np.abs(staged - fused).max() <= 1
    want = video.run_video_pipeline(
        params.fisrnet_from_jax(ftree, device="cpu"), params.pwcnet_from_jax(ptree, device="cpu"),
        folder, out_folder=str(tmp_path / "api"), frame_num=3, fused=True, fisr_grid=(1, 2),
        device="cpu", verbose=False)
    tiled = run("tiled", "--fused", "--fisr_grid", "1,2")
    np.testing.assert_array_equal(tiled, np.stack([read_png(p) for p in want]))
    auto = run("auto", "--fused", "--fisr_grid", "auto")
    # no weights anywhere: no flag, no checkpoint under --checkpoint_dir
    with pytest.raises(SystemExit, match="weights"):
        main(base + ["--fused", "--checkpoint_dir", str(tmp_path / "no_ckpt")])
    # 'tuned' with this size never tuned on this device: the 'auto' plan
    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH", str(tmp_path / "tune.json"))
    np.testing.assert_array_equal(run("tuned", "--fused", "--fisr_grid", "tuned"), auto)
    # the train phase is ported: it gets as far as reading its corpus
    with pytest.raises(OSError):
        main(base + weights + ["--phase", "train", "--train_data_path", str(tmp_path / "no.mat"),
                               "--checkpoint_dir", str(tmp_path / "ck"),
                               "--text_dir", str(tmp_path / "txt"), "--log_dir", str(tmp_path / "log")])
