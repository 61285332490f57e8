"""Port: metrics, sequence algebra and the `test` phase (ops/metrics.py,
ops/seq.py, infer/evaluate.py, infer/video_eval.py, the CLI's --phase test)
against the JAX package and the TF-oracle fixtures.

f32, one thread. Measured (CPU): ssim against tf.image.ssim (ssim_tf.npz)
1.13e-5 (bound 1e-4, as tests/test_metrics.py), against the JAX ssim 3.6e-7
(bound 1e-5); psnr_image 0 dB against JAX (bound 1e-4); ssim_pil_like and
psnr_np equal to JAX's (the same float64 numpy arithmetic); the `test`
phase against the reference's own run (test_phase.npz): the four means
within 4.7e-9 (bound 1e-6), saved PNGs equal on 100 % of pixels (bound: 1
u8 count, 99.9 % equal); EvalResult against the JAX evaluate_test_set at
ch=8 within 7.5e-9 (bound 1e-6), saved PNGs within 1 u8 count;
evaluate_video_folder within 3.2e-7 (bound 1e-6); the saved PNGs of one
scene of the same predictions equal the JAX package's bit for bit (both
colour with the JAX native library's constants).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fisr_tpu.data import flo as jflo
from fisr_tpu.data import matio as jmatio
from fisr_tpu.infer import evaluate as jevaluate
from fisr_tpu.infer import tiled as jtiled
from fisr_tpu.infer import video_eval as jvideo_eval
from fisr_tpu.infer.device import FastTiledRunner as JFastTiledRunner
from fisr_tpu.models import fisrnet as jfisrnet
from fisr_tpu.ops import metrics as jmetrics
from fisr_tpu.ops import seq as jseq
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.convert.oracle import deterministic_tf_vars, tf_vars_digest
from fisr_tpu_torch.data import flo, matio
from fisr_tpu_torch.data.png_io import read_png, write_png
from fisr_tpu_torch.infer import evaluate, tiled, video_eval
from fisr_tpu_torch.infer.device import FastTiledRunner
from fisr_tpu_torch.ops import metrics, seq

torch.set_num_threads(1)
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "tf_oracle")


def _pair(seed, shape, noise=0.05):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    return a, np.clip(a + rng.normal(scale=noise, size=shape), 0, 1).astype(np.float32)


def _ssim_cases():
    with open(os.path.join(FIX, "ssim_manifest.json")) as f:
        return [(c["name"], c["max_val"]) for c in json.load(f)["cases"]]


@pytest.mark.parametrize("name,max_val", _ssim_cases())
def test_ssim_matches_tf_image_ssim_fixture(name, max_val):
    fx = np.load(os.path.join(FIX, "ssim_tf.npz"))
    ours = metrics.ssim(fx[f"{name}_a"], fx[f"{name}_b"], max_val=max_val).numpy()
    np.testing.assert_allclose(ours.astype(np.float64), fx[f"{name}_ssim"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 32, 40, 3), (24, 24, 1)])
def test_ssim_and_psnr_image_match_jax(shape):
    a, b = _pair(1, shape)
    want = np.asarray(jmetrics.ssim(a, b))
    got = metrics.ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(metrics.ssim(a, a).numpy(), 1.0, atol=1e-5)
    want = np.asarray(jmetrics.psnr_image(a, b))
    np.testing.assert_allclose(metrics.psnr_image(a, b).numpy(), want, rtol=0, atol=1e-4)
    assert metrics.psnr_np(a.astype(np.float64), b.astype(np.float64)) == \
        jmetrics.psnr_np(a.astype(np.float64), b.astype(np.float64))


def test_ssim_pil_like_analytic_single_tile_and_jax():
    a = np.full((7, 7), 100 / 255.0)
    b = np.full((7, 7), 120 / 255.0)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    expected = ((2 * 100 * 120 + c1) * c2) / ((100**2 + 120**2 + c1) * c2)
    np.testing.assert_allclose(metrics.ssim_pil_like(a, b), expected, rtol=1e-12)
    x, y = _pair(2, (23, 30, 3), noise=0.1)
    assert metrics.ssim_pil_like(x, y) == jmetrics.ssim_pil_like(x, y)
    assert metrics.ssim_pil_like(x, x) == 1.0
    # truncation, not rounding: 254/255 and 254.4/255 are one uint8 value
    assert metrics.ssim_pil_like(np.full((7, 7), 254 / 255), np.full((7, 7), 254.4 / 255)) == 1.0


def test_seq_algebra_matches_jax():
    rng = np.random.default_rng(3)
    x5 = rng.normal(size=(2, 5, 6, 8, 3)).astype(np.float32)
    merged = seq.merge_seq_dim(torch.from_numpy(x5))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jseq.merge_seq_dim(jnp.asarray(x5))))
    np.testing.assert_array_equal(seq.split_seq_dim(merged).numpy(), x5)
    img, fl, wp = (rng.normal(size=(2, 6, 8, c)).astype(np.float32) for c in (15, 16, 24))
    want = np.asarray(jseq.stack_windows(jnp.asarray(img), jnp.asarray(fl), jnp.asarray(wp)))
    got = seq.stack_windows(torch.from_numpy(img), torch.from_numpy(fl), torch.from_numpy(wp))
    assert got.shape == (6, 6, 8, 29)
    np.testing.assert_array_equal(got.numpy(), want)
    g = rng.normal(size=(2, 9, 4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(seq.groups_to_overlap(torch.from_numpy(g)).numpy(),
                                  np.asarray(jseq.groups_to_overlap(jnp.asarray(g))))


def _write_scene(root, lr, gt, flow, warp, mods=(flo, matio)):
    lr_dir, gt_dir = os.path.join(root, "input"), os.path.join(root, "gt")
    os.makedirs(lr_dir)
    os.makedirs(gt_dir)
    for i, fr in enumerate(lr):
        write_png(fr, os.path.join(lr_dir, f"LR_{i + 1:05d}.png"))
    for i, fr in enumerate(gt):
        write_png(fr, os.path.join(gt_dir, f"HR_{i + 1:05d}.png"))
    flow_path, warp_path = os.path.join(root, "test.flo"), os.path.join(root, "test_warp.mat")
    mods[0].write_flo_5dim(flow, flow_path)
    mods[1].write_warp_mat(warp, warp_path)
    return lr_dir, gt_dir, flow_path, warp_path


def test_eval_engine_matches_reference_test_phase(tmp_path):
    """evaluate_test_set on TiledRunner(mode='exact') against FISRnet.test()
    run verbatim: the window composition, the VFI-SR / SR accounting, the
    PSNR and the saved RGB predictions."""
    with open(os.path.join(FIX, "test_phase_manifest.json")) as f:
        man = json.load(f)
    z = np.load(os.path.join(FIX, "test_phase.npz"))
    h, w = man["scene"]["h"], man["scene"]["w"]
    model = params.deterministic_fisrnet(device="cpu")
    shapes = params._tf_shapes(model, params.fisrnet_name_map())
    assert tf_vars_digest(deterministic_tf_vars(shapes)) == man["weights_digest"]
    lr_dir, gt_dir, flow_path, warp_path = _write_scene(
        str(tmp_path), z["lr"], z["gt"], z["flow"], z["warp"])
    out_dir = str(tmp_path / "out")
    runner = tiled.TiledRunner(model, grid=tuple(man["scene"]["patch"]), boundary=32,
                               mode="exact", device="cpu")
    res = evaluate.evaluate_test_set(runner, lr_dir, gt_dir, flow_path, warp_path,
                                     out_dir=out_dir, input_size=(h, w), verbose=False,
                                     ssim_impl="pil")
    assert abs(res.psnr_vfi_sr - z["mean_psnr"][0]) < 1e-6
    assert abs(res.psnr_sr - z["mean_psnr"][1]) < 1e-6
    assert abs(res.ssim_vfi_sr - z["mean_ssim"][0]) < 1e-6
    assert abs(res.ssim_sr - z["mean_ssim"][1]) < 1e-6
    assert res.n_frames == 7 and res.sec_per_frame > 0 and res.compile_sec > 0
    ours = np.stack([read_png(os.path.join(out_dir, name)) for name in man["pred_names"]])
    d = np.abs(ours.astype(np.int32) - z["preds_rgb"].astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.999, (d == 0).mean()


@pytest.fixture(scope="module")
def small():
    from fisr_tpu.convert.tf_import import convert_fisrnet, export_fisrnet

    shapes = {n: a.shape for n, a in export_fisrnet(
        jfisrnet.init_params(jax.random.PRNGKey(0), ch=8)).items()}
    tree = convert_fisrnet(deterministic_tf_vars(shapes))
    return tree, params.fisrnet_from_jax(tree, device="cpu")


def _scene(seed, h=64, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:2 * h, 0:2 * w].astype(np.float32)

    def frame(t):
        return np.stack([127.5 + 100 * np.sin(0.11 * (xx - 2 * t) + 0.07 * (yy - t) + c)
                         for c in range(3)], -1)

    hr = np.stack([frame(t) for t in range(9)]).astype(np.uint8)
    lr, gt = hr[::2, ::2, ::2], hr[1:8]  # 5 LR frames, the 7 HR frames between them
    flow = rng.normal(scale=3.0, size=(1, 8, h, w, 2)).astype(np.float32)
    warp = np.repeat(lr[None, :4].astype(np.float32), 2, axis=1)  # [1, 8, h, w, 3] in [0, 255]
    return lr, gt, flow, warp + rng.normal(scale=2.0, size=warp.shape).astype(np.float32)


FIELDS = ("psnr_vfi_sr", "psnr_sr", "ssim_vfi_sr", "ssim_sr")


@pytest.mark.parametrize("engine,ssim_impl", [("exact", "gaussian"), ("fast", "pil")])
def test_evaluate_test_set_matches_jax(tmp_path, small, engine, ssim_impl):
    """The same files through both packages; the JAX side's own writers made
    the .flo and .mat that the port reads."""
    tree, model = small
    lr, gt, flow, warp = _scene(4)
    lr_dir, gt_dir, flow_path, warp_path = _write_scene(str(tmp_path), lr, gt, flow, warp,
                                                        mods=(jflo, jmatio))
    if engine == "exact":
        jrunner = jtiled.TiledRunner(tree, grid=(1, 2), boundary=16)
        runner = tiled.TiledRunner(model, grid=(1, 2), boundary=16, device="cpu")
    else:
        jrunner = JFastTiledRunner(tree, grid=(2, 2), boundary=16)
        runner = FastTiledRunner(model, grid=(2, 2), boundary=16, device="cpu")
    kw = dict(input_size=(64, 64), verbose=False, ssim_impl=ssim_impl)
    want = jevaluate.evaluate_test_set(jrunner, lr_dir, gt_dir, flow_path, warp_path,
                                       out_dir=str(tmp_path / "jax"), **kw)
    got = evaluate.evaluate_test_set(runner, lr_dir, gt_dir, flow_path, warp_path,
                                     out_dir=str(tmp_path / "port"), **kw)
    for field in FIELDS:
        assert abs(getattr(got, field) - getattr(want, field)) < 1e-6, field
    assert got.n_frames == want.n_frames == 7
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 7
    for name in names:
        a = read_png(tmp_path / "port" / name).astype(np.int16)
        b = read_png(tmp_path / "jax" / name).astype(np.int16)
        assert np.abs(a - b).max() <= 1, name


def test_evaluate_saves_the_jax_packages_frames_bit_for_bit(tmp_path):
    """One scene whose predictions (from one oracle runner, so the same in
    both packages) hold every YUV triple on which the JAX native library's
    constants and ops/color's truncate apart: the port's saved RGB frames
    equal fisr_tpu.infer.evaluate's, pixel for pixel, and the ops/color
    route would not have."""
    from fisr_tpu_torch import native
    from fisr_tpu_torch.ops import color

    a = np.arange(1 << 24, dtype=np.uint32)
    tri = np.stack([(a >> 16) & 255, (a >> 8) & 255, a & 255], -1).astype(np.uint8)
    apart = tri[(native.yuv2rgb_matlab_u8(tri) != native.yuv2rgb_ops_u8(tri)).any(-1)]
    assert len(apart) == 87
    lr, gt, flow, warp = _scene(7)
    lr_dir, gt_dir, flow_path, warp_path = _write_scene(str(tmp_path), lr, gt, flow, warp,
                                                        mods=(jflo, jmatio))
    rng = np.random.default_rng(8)
    pred_u8 = rng.integers(0, 256, (3, 128, 128, 3, 3), dtype=np.uint8)
    pred_u8.reshape(-1, 3)[:3 * len(apart)] = np.tile(apart, (3, 1))
    pred_u8 = pred_u8.reshape(3, 128, 128, 9)
    preds = ((pred_u8.astype(np.float32) + 0.5) / 255).astype(np.float32)
    assert np.array_equal(np.uint8(preds * 255), pred_u8)

    class Oracle:
        grid, sf, device = (1, 1), 2, torch.device("cpu")

        def __call__(self, inp):
            return preds

    kw = dict(input_size=(64, 64), verbose=False, ssim_impl="pil")
    jevaluate.evaluate_test_set(Oracle(), lr_dir, gt_dir, flow_path, warp_path,
                                out_dir=str(tmp_path / "jax"), **kw)
    evaluate.evaluate_test_set(Oracle(), lr_dir, gt_dir, flow_path, warp_path,
                               out_dir=str(tmp_path / "port"), **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 7
    ops_route_differs = False
    for name in names:
        ours, theirs = read_png(tmp_path / "port" / name), read_png(tmp_path / "jax" / name)
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
        window, s = divmod(int(name.split("_")[-1][:-4]) - 1, 2)
        window, s = (window, s) if window < 3 else (2, 2)  # the last frame: window 2's third
        ops_route_differs |= not np.array_equal(
            color.yuv2rgb_matlab_u8(pred_u8[window, :, :, 3 * s:3 * s + 3]), ours)
    assert ops_route_differs


def test_evaluate_scenes_scores_identity(tmp_path, small):
    """A runner that returns the ground truth scores SSIM 1 and a PSNR at
    the f32 rounding of the prediction (mse ~1e-15, about 150 dB; infinite
    where the mse is exactly 0, as in the JAX function); 4 + 3 frames."""
    lr, gt, flow, warp = _scene(5)
    lr_dir, gt_dir, _, _ = _write_scene(str(tmp_path), lr, gt, flow, warp)

    class Oracle:
        grid, sf, device = (1, 1), 2, torch.device("cpu")

        def __call__(self, inp):
            if not inp.any():
                return np.zeros((3, 128, 128, 9), np.float32)
            return np.stack([np.concatenate(list(gt[2 * i:2 * i + 3]), 2)
                             for i in range(3)]).astype(np.float32) / 255.0

    with np.errstate(divide="ignore"):
        res = evaluate.evaluate_scenes(Oracle(), lr_dir, gt_dir, flow, warp / 255.0,
                                       input_size=(64, 64), verbose=False)
    assert res.psnr_vfi_sr > 120 and res.psnr_sr > 120
    assert abs(res.ssim_vfi_sr - 1) < 1e-6 and abs(res.ssim_sr - 1) < 1e-6
    assert res.n_frames == 7


def test_evaluate_video_folder_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    os.makedirs(pred_dir)
    os.makedirs(gt_dir)
    for k in range(5):
        g = rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8)
        p = np.clip(g.astype(np.int16) + rng.integers(-6, 7, size=g.shape), 0, 255).astype(np.uint8)
        write_png(g, gt_dir / f"gt_{k}.png")
        write_png(p, pred_dir / f"pred_YUV_{k}.png")
        write_png(p, pred_dir / f"pred_{k}.png")  # RGB twin: not scored
    want = jvideo_eval.evaluate_video_folder(str(pred_dir), str(gt_dir))
    got = video_eval.evaluate_video_folder(str(pred_dir), str(gt_dir), device="cpu")
    assert (got.n_vfi_sr, got.n_sr) == (want.n_vfi_sr, want.n_sr) == (3, 2)
    for field in FIELDS:
        assert abs(getattr(got, field) - getattr(want, field)) < 1e-6, field
    assert got.as_dict().keys() == want.as_dict().keys()
    with pytest.raises(ValueError, match="index-aligned"):
        video_eval.evaluate_video_folder(str(gt_dir), str(tmp_path), device="cpu")


@pytest.mark.parametrize("engine", ["exact", "fast"])
def test_cli_test_phase(tmp_path, small, engine):
    from fisr_tpu_torch.cli.main import main

    tree, model = small
    lr, gt, flow, warp = _scene(7)
    lr_dir, gt_dir, flow_path, warp_path = _write_scene(str(tmp_path), lr, gt, flow, warp)
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}
    np.savez(tmp_path / "fisr.npz", **flat)
    res = main(["--phase", "test", "--device", "cpu", "--compute_dtype", "float32",
                "--eval_engine", engine, "--ssim_impl", "pil", "--test_patch", "1", "2",
                "--test_input_size", "64", "64", "--test_data_path", lr_dir,
                "--test_label_path", gt_dir, "--test_flow_data_path", flow_path,
                "--test_warped_data_path", warp_path, "--test_img_dir", str(tmp_path / "imgs"),
                "--fisr_params_npz", str(tmp_path / "fisr.npz")])
    make = tiled.TiledRunner if engine == "exact" else FastTiledRunner
    want = evaluate.evaluate_test_set(make(model, grid=(1, 2), device="cpu"), lr_dir, gt_dir,
                                      flow_path, warp_path, input_size=(64, 64),
                                      verbose=False, ssim_impl="pil")
    for field in FIELDS:
        assert getattr(res, field) == getattr(want, field), field
    assert sorted(os.listdir(tmp_path / "imgs" / "FISRnet_exp1")) == \
        [f"pred_{i:05d}.png" for i in range(1, 8)]
