"""Port: the corpus tools, cli/prepare.py and cli/build_corpus.py, against
fisr_tpu.cli.{prepare,build_corpus} and the corpus-prep oracle fixtures
(tests/test_corpus_prep_oracle.py), on the CPU.

The inputs are the fixture's frames (2 sequences of 5 YUV frames, 32x32) and
the TF-oracle generator's PWC-Net (lg-6-2, as the JAX functions always run
it). Measured (f32, CPU): flows against the JAX flows_for_sequences, max
|diff| 7.9e-8 px of a max |flow| 0.043 px (ss=1) and 8.9e-8 of 0.043 (ss=2)
(bound 1e-4 of max |flow|); warps against the JAX warps_for_sequences on the
same flows, 4.6e-5 on [0, 255] values at both strides (bound 1e-3); against
the fixtures, warps 0.365 / 0.350 u8 counts (bound 1.5), the amplified chain
0.564 (bound 2.0), flows rms 0.073 of the reference's rms (bound 0.25), the
bounds of tests/test_corpus_prep_oracle.py.
"""

import json
import os

import numpy as np
import pytest
import torch


from fisr_tpu.cli import build_corpus as jbuild
from fisr_tpu.cli import prepare as jprepare
from fisr_tpu.convert.tf_import import convert_pwcnet
from fisr_tpu.data.dataset import TrainStore
from fisr_tpu.data.synth import _scene
from fisr_tpu.native import rgb2yuv_matlab_u8 as jax_rgb2yuv_matlab_u8
from fisr_tpu_torch.cli import build_corpus, prepare
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.convert.oracle import deterministic_tf_vars, tf_vars_digest
from fisr_tpu_torch.data import flo, matio
from fisr_tpu_torch.data.png_io import list_pngs, write_png
from fisr_tpu_torch.models import pwcnet
from fisr_tpu_torch.ops.color import rgb2yuv_matlab_u8
from fisr_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "tf_oracle")


@pytest.fixture(scope="module")
def oracle():
    with open(os.path.join(FIX, "corpus_prep_manifest.json")) as f:
        man = json.load(f)
    return man, np.load(os.path.join(FIX, "corpus_prep.npz"))


@pytest.fixture(scope="module")
def weights():
    """The generator's PWC-Net: its TF variables, the port's module and the
    JAX tree of the same weights."""
    name_map = params.pwcnet_name_map()
    shapes = params.jax_shapes(pwcnet.PWCNet(device="cpu"))
    tf_vars = deterministic_tf_vars({name: shapes[path] for name, path in name_map.items()})
    return tf_vars, params.deterministic_pwcnet(device="cpu"), convert_pwcnet(tf_vars)


@pytest.fixture(scope="module")
def flows(oracle, weights):
    """{ss: (the port's flows, the JAX package's)} of the fixture's frames."""
    _, z = oracle
    _, model, tree = weights
    return {ss: (prepare.flows_for_sequences(model, z["data_yuv"], ss, device="cpu"),
                 jprepare.flows_for_sequences(tree, z["data_yuv"], ss))
            for ss in (1, 2)}


@pytest.mark.parametrize("ss", [1, 2])
def test_flows_and_warps_match_jax(oracle, flows, ss):
    _, z = oracle
    ours, theirs = flows[ss]
    assert ours.shape == theirs.shape == (2, 8 // ss, 32, 32, 2) and ours.dtype == np.float32
    scale = np.abs(theirs).max()
    assert scale > 0.01 and np.abs(ours - theirs).max() <= 1e-4 * scale
    # warps on the same flows (the JAX package's), positions 2i and 2i+1
    w_ours = prepare.warps_for_sequences(z["data_yuv"], theirs, ss, device="cpu")
    w_theirs = jprepare.warps_for_sequences(z["data_yuv"], theirs, ss)
    assert w_ours.shape == w_theirs.shape == (2, 8 // ss, 32, 32, 3)
    assert np.abs(w_ours - w_theirs).max() <= 1e-3


@pytest.mark.parametrize("ss", [1, 2])
def test_flows_and_warps_match_the_reference_prep_chain(oracle, weights, flows, ss):
    """The bounds of tests/test_corpus_prep_oracle.py: flows within the
    resize chain's deviation, warps on the reference's flows within its
    interpolator's quantization."""
    man, z = oracle
    assert tf_vars_digest(weights[0]) == man["weights_digest"]
    ref = z[f"flow_ss{ss}"]
    ours = flows[ss][0]
    assert np.sqrt(np.mean((ours - ref) ** 2)) <= 0.25 * np.sqrt(np.mean(ref ** 2))
    np.testing.assert_array_equal(flo.read_flo_5dim(os.path.join(FIX, f"corpus_ss{ss}.flo")), ref)
    warps = prepare.warps_for_sequences(z["data_yuv"], ref, ss, device="cpu")
    assert np.abs(warps - z[f"warp_ss{ss}"]).max() <= 1.5


def test_amplified_warp_chain_pins_the_layout(oracle):
    man, z = oracle
    ours = prepare.warps_for_sequences(z["data_yuv"], z["flow_amp"], 1, device="cpu")
    ref = z["warp_amp"]
    dev = np.abs(ours - ref).max()
    assert dev <= 2.0
    n, h, w = man["n"], man["h"], man["w"]
    swapped = ref.reshape(n, 4, 2, h, w, 3)[:, :, ::-1].reshape(ref.shape)
    assert np.abs(ours - swapped).max() > 10 * dev


def test_prepare_cli_takes_a_port_checkpoint(tmp_path, oracle, weights, flows, capsys):
    _, z = oracle
    _, model, _ = weights
    ck = str(tmp_path / "pwc")
    CheckpointManager(ck).save(3, {"params": params.to_jax_tree(model)})
    # flow-from-pngs: the frames of both sequences as one folder of PNGs
    png_dir = tmp_path / "pngs"
    png_dir.mkdir()
    frames = z["data_yuv"].reshape(10, 32, 32, 3).round().astype(np.uint8)
    for i, fr in enumerate(frames):
        write_png(fr, png_dir / f"fr_{i:03d}.png")
    out = str(tmp_path / "test.flo")
    prepare.main(["flow-from-pngs", "--png_dir", str(png_dir), "--out", out, "--pwc_ckpt", ck,
                  "--device", "cpu"])
    assert f"[*] wrote {out}" in capsys.readouterr().out
    seqs = frames.reshape(2, 5, 32, 32, 3).astype(np.float32)
    np.testing.assert_array_equal(flo.read_flo_5dim(out),
                                  prepare.flows_for_sequences(model, seqs, 1, device="cpu"))
    # flow-from-mat and warp-from-mat at ss=2, through the .mat files
    mat = str(tmp_path / "lr.mat")
    matio.write_train_mat(mat, "LR_data", z["data_yuv"])
    flo_path, warp_path = str(tmp_path / "ss2.flo"), str(tmp_path / "ss2_warp.mat")
    prepare.main(["flow-from-mat", "--mat", mat, "--ss", "2", "--out", flo_path,
                  "--pwc_ckpt", ck, "--device", "cpu"])
    np.testing.assert_allclose(flo.read_flo_5dim(flo_path), flows[2][0], rtol=0, atol=1e-5)
    prepare.main(["warp-from-mat", "--mat", mat, "--flo", flo_path, "--ss", "2",
                  "--out", warp_path, "--device", "cpu"])
    want = prepare.warps_for_sequences(z["data_yuv"], flo.read_flo_5dim(flo_path), 2, device="cpu")
    np.testing.assert_allclose(matio.read_warp_mat(warp_path) * 255.0, want, rtol=0, atol=1e-3)
    # without --pwc_ckpt the flow commands stop
    with pytest.raises(SystemExit, match="--pwc_ckpt"):
        prepare.main(["flow-from-mat", "--mat", mat, "--out", flo_path, "--device", "cpu"])


def test_build_corpus_matches_jax(tmp_path, weights, monkeypatch):
    """The same seed gives the JAX package's LR/HR patches exactly, and files
    that the JAX TrainStore reads; the JAX side's flows are stubbed (the
    tests above hold them against the port's)."""
    _, model, _ = weights
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    scene = _scene(np.random.default_rng(0), 12, 96, 128)
    for i in range(12):
        write_png(scene[i].astype(np.uint8), frames_dir / f"fr_{i:03d}.png")
    paths = list_pngs(str(frames_dir))
    ours = build_corpus.build_corpus(paths, str(tmp_path / "ours"), 3, 32, pwc=model, seed=0,
                                     verbose=False, device="cpu")
    monkeypatch.setattr(jprepare, "flows_for_sequences",
                        lambda p, seqs, ss=1, policy=None: np.zeros(
                            (len(seqs), 8 // ss, *seqs.shape[2:4], 2), np.float32))
    monkeypatch.setattr(jprepare, "warps_for_sequences",
                        lambda seqs, fl, ss=1: np.zeros((len(seqs), 8 // ss, *seqs.shape[2:4], 3),
                                                        np.float32))
    theirs = jbuild.build_corpus(paths, str(tmp_path / "theirs"), 3, 32, pwc_params={}, seed=0,
                                 verbose=False)
    for key in ("data_path", "label_path"):
        name = "LR_data" if key == "data_path" else "HR_data"
        np.testing.assert_array_equal(matio.read_train_mat(ours[key], name),
                                      matio.read_train_mat(theirs[key], name))
    store = TrainStore.from_files(**ours, val_size=1)
    assert store.data.shape == (3, 32, 32, 15) and store.label.shape == (3, 64, 64, 21)
    assert store.flow.shape == (3, 32, 32, 16) and store.flow_ss2.shape == (3, 32, 32, 8)
    assert store.warp.shape == (3, 32, 32, 24) and store.warp_ss2.shape == (3, 32, 32, 12)
    lr = matio.read_train_mat(ours["data_path"], "LR_data") * 255.0
    np.testing.assert_array_equal(flo.read_flo_5dim(ours["flow_path"]),
                                  prepare.flows_for_sequences(model, lr, 1, device="cpu"))
    with pytest.raises(SystemExit, match="--pwc_ckpt"):
        build_corpus.main(["--frames", str(frames_dir), "--out", str(tmp_path / "x"),
                           "--device", "cpu"])


def test_rgb2yuv_matlab_u8_matches_jax():
    rgb = np.random.default_rng(0).integers(0, 256, (256, 256, 3), dtype=np.uint8)
    ours = rgb2yuv_matlab_u8(rgb)
    assert ours.dtype == np.uint8 and ours.shape == rgb.shape
    assert int((ours != jax_rgb2yuv_matlab_u8(rgb)).sum()) == 0
    # and the JAX package's numpy route (its fallback without the native library)
    from fisr_tpu.ops import color as jcolor

    numpy_route = np.clip(np.asarray(jcolor.rgb2yuv_matlab(rgb.astype(np.float32))),
                          0, 255).astype(np.uint8)
    assert int((ours != numpy_route).sum()) == 0
