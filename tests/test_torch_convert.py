"""Port: weights in. The orbax reader (convert/orbax_read.py) and
CheckpointManager.restore against the JAX package's orbax manager, the
TensorBundle reader and writer (convert/tensor_bundle.py) against the JAX
package's, TF1 import (convert/tf_import.py) and the conversion CLI
(convert/cli.py), on the CPU.

Measured (f32, CPU): the port's PWC-Net on the repo's trained tree
(checkpoint_dir/pwcnet step 14000) against fisr_tpu.models.pwcnet.apply on
the same tree, max |diff| 2.7e-6 px of a max |flow| 0.93 px at 64x64 and
4.5e-6 of 2.19 at 128x192 (bound 1e-4 of max |flow|); models built from TF1
bundles against the JAX apply on the JAX import of the same bundle: FISRnet
pred_l3 4.5e-7 of 0.44, PWC-Net flow 1.5e-7 of 0.087 (bound 1e-4 of the
largest output).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fisr_tpu.convert import tensor_bundle as jtb
from fisr_tpu.convert import tf_import as jtf
from fisr_tpu.models import fisrnet as jfisrnet
from fisr_tpu.models import pwcnet as jpwcnet
from fisr_tpu.train import trainer as jtrainer
from fisr_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from fisr_tpu_torch.convert import params, tf_import
from fisr_tpu_torch.convert import tensor_bundle as tb
from fisr_tpu_torch.convert.orbax_read import read_orbax_tree
from fisr_tpu_torch.models import fisrnet, pwcnet
from fisr_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(ROOT, "checkpoint_dir", "pwcnet")
FIX = os.path.join(ROOT, "tests", "fixtures", "tf_oracle")
REL = 1e-4  # of the largest output


def _assert_trees_equal(got, want, path=()):
    """Same structure (dicts, lists), same dtypes for array leaves, values
    bit-equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], path + (k,))
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, path + (i,))
    else:
        w = np.asarray(want)
        if isinstance(want, np.ndarray):
            assert got.dtype == w.dtype, (path, got.dtype, w.dtype)
        assert got.shape == w.shape, (path, got.shape, w.shape)
        np.testing.assert_array_equal(got, w, err_msg=str(path))


@pytest.fixture(scope="module")
def trained():
    """The repo's trained PWC-Net, read by each package."""
    step = JaxCheckpointManager(TRAINED, best_mode="min").best_step()
    return (read_orbax_tree(os.path.join(TRAINED, f"step_{step}")),
            JaxCheckpointManager(TRAINED).restore(step))


# ---- orbax ------------------------------------------------------------------------

def test_orbax_trained_tree_is_bit_equal_to_the_jax_restore(trained):
    ours, theirs = trained
    _assert_trees_equal(ours, theirs)
    leaves = list(params.flatten_tree(ours["params"]))
    assert len(leaves) == 182 and all(a.dtype == np.float32 for _, a in leaves)
    # and CheckpointManager.restore takes the same route
    _assert_trees_equal(CheckpointManager(TRAINED).restore(14000), theirs)


@pytest.mark.parametrize("hw", [(64, 64), (128, 192)])
def test_orbax_trained_pwcnet_matches_jax_apply(trained, hw):
    ours, theirs = trained
    model = params.pwcnet_from_jax(ours["params"], device="cpu")
    rng = np.random.default_rng(hw[1])
    x = rng.uniform(size=(2, 1, *hw, 3)).astype(np.float32)
    # a shifted copy, so that the flow is not zero
    x[1] = np.roll(x[0], (2, 3), axis=(1, 2))
    want, _ = jpwcnet.apply(jax.tree_util.tree_map(jnp.asarray, theirs["params"]),
                            jnp.asarray(x[0]), jnp.asarray(x[1]))
    want = np.asarray(want)
    with torch.no_grad():
        got, _ = pwcnet.apply(model, torch.from_numpy(x[0]), torch.from_numpy(x[1]), model.cfg)
    got = got.numpy()
    assert got.shape == want.shape == (1, *hw, 2)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0.5 and err <= REL * scale, (err, scale)


def test_orbax_old_layout_tree_raises_naming_the_key():
    """checkpoint_dir/pwcnet_joint holds the deconv layout from before the
    JAX package's round 5 ([4, 4, IN, OUT]); it reads, and building the
    model from it names the first key whose shape differs."""
    tree = CheckpointManager(os.path.join(ROOT, "checkpoint_dir", "pwcnet_joint")).restore()
    assert tree["params"]["up"]["level_6"]["feat"]["w"].shape == (4, 4, 529, 2)
    with pytest.raises(ValueError, match=r"up\.level_\d\.feat\.weight: shape"):
        params.pwcnet_from_jax(tree["params"], device="cpu")


def _jax_train_state():
    p = {"a": {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)},
         "c": {"w": jnp.full((4,), 2.0, jnp.float32)}}
    opt = jtrainer.adam_with_schedule(lambda s: 1e-3)
    return {"params": p, "opt_state": opt.init(p), "step": jnp.asarray(7, jnp.int32)}


def test_orbax_jax_training_checkpoint_restores_and_fills_a_template(tmp_path):
    JaxCheckpointManager(str(tmp_path)).save(7, _jax_train_state())
    want = JaxCheckpointManager(str(tmp_path)).restore(7)
    got = CheckpointManager(str(tmp_path)).restore()
    _assert_trees_equal(got, want)
    assert isinstance(got["opt_state"], list) and int(got["step"]) == 7
    assert got["step"].dtype == np.int32
    # restore(item=): the template's structure and dtypes, shapes checked
    template = {"params": {"a": {"w": np.zeros((2, 3), np.float64), "b": np.zeros(3)},
                           "c": {"w": np.zeros(4, np.float16)}},
                "step": np.int64(0)}
    template_full = dict(template, opt_state=[{"count": 0, "mu": template["params"],
                                               "nu": template["params"]}, {"count": 0}])
    out = CheckpointManager(str(tmp_path)).restore(7, item=template_full)
    assert out["params"]["a"]["w"].dtype == np.float64
    assert out["params"]["c"]["w"].dtype == np.float16
    np.testing.assert_array_equal(out["params"]["a"]["w"], np.arange(6.0).reshape(2, 3))
    assert out["step"].dtype == np.int64 and int(out["step"]) == 7
    bad = dict(template_full, params={**template["params"], "c": {"w": np.zeros(5)}})
    with pytest.raises(ValueError, match="params/c/w: shape"):
        CheckpointManager(str(tmp_path)).restore(7, item=bad)
    with pytest.raises(KeyError, match="unexpected \\['opt_state'\\]"):
        CheckpointManager(str(tmp_path)).restore(7, item=template)


# ---- TensorBundle -----------------------------------------------------------------

def test_bundle_reads_the_real_saver_fixture():
    want = np.load(os.path.join(FIX, "tiny_real_ckpt_expect.npz"))
    got = tb.read_bundle(os.path.join(FIX, "tiny_real_ckpt"), verify=True)
    assert sorted(got) == sorted(want.files)
    for name in want.files:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert tb.list_variables(os.path.join(FIX, "tiny_real_ckpt"))[
        "odd/shape/scalarish"] == ((1, 1, 2, 2), np.dtype("<f4"))


def _mixed_tensors():
    import ml_dtypes

    rng = np.random.default_rng(0)
    t = {
        "a/w": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
        "a/b": rng.normal(size=(8,)).astype(np.float32),
        "counts": rng.integers(0, 100, size=(5, 2)).astype(np.int64),
        "flags": np.array([True, False, True]),
        "half": rng.normal(size=(4, 4)).astype(np.float16),
        "bf16": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
        "u8": rng.integers(0, 255, size=(6,)).astype(np.uint8),
        "empty": np.zeros((0,), np.float32),
        "empty2d": np.zeros((0, 3), np.float32),
    }
    # 400 more small tensors: several 4 KB blocks, prefix compression,
    # restart arrays and the index block
    t.update({f"net/layer_{i:03d}/sub_{j}/kernel": rng.normal(size=(j + 1, 3)).astype(np.float32)
              for i in range(100) for j in range(4)})
    return t


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_bundles_read_bit_equal_across_packages(tmp_path, writer, reader):
    tensors = _mixed_tensors()
    prefix = str(tmp_path / "model.ckpt-100")
    (tb if writer == "port" else jtb).write_bundle(prefix, tensors)
    got = (tb if reader == "port" else jtb).read_bundle(prefix, verify=True)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].view(np.uint8), v.view(np.uint8), err_msg=k)
    lv = (tb if reader == "port" else jtb).list_variables(prefix)
    assert lv["counts"] == ((5, 2), np.dtype("<i8")) and lv["empty2d"] == ((0, 3), np.dtype("<f4"))
    # a 0-d tensor (global_step, beta1_power) keeps its shape here; the JAX
    # writer stores it as (1,)
    scalar = str(tmp_path / "scalar")
    tb.write_bundle(scalar, {"global_step": np.asarray(122000, np.int64)})
    assert (tb if reader == "port" else jtb).read_bundle(scalar)["global_step"].shape == ()
    # the files themselves are the same bytes
    other = str(tmp_path / "other")
    (jtb if writer == "port" else tb).write_bundle(other, tensors)
    for suffix in (".index", ".data-00000-of-00001"):
        with open(prefix + suffix, "rb") as a, open(other + suffix, "rb") as b:
            assert a.read() == b.read(), suffix


def test_bundle_crc32c_lanes_match_the_byte_loop():
    assert tb._crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    rng = np.random.default_rng(1)
    for n in (0, 1, 4095, 4096, 4097, 100_003, (1 << 20) + 7):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for crc in (0, 0x12345678):
            want = tb._crc_register(crc ^ 0xFFFFFFFF, data) ^ 0xFFFFFFFF
            assert tb._crc32c(data, crc) == want == jtb._crc32c(data, crc), n


def test_bundle_corruption_and_bad_index_are_detected(tmp_path):
    prefix = str(tmp_path / "bad")
    tb.write_bundle(prefix, {"x": np.arange(1024, dtype=np.float32)})
    data_path = prefix + ".data-00000-of-00001"
    raw = bytearray(open(data_path, "rb").read())
    raw[100] ^= 0xFF
    open(data_path, "wb").write(bytes(raw))
    tb.read_bundle(prefix)  # verify=False, the default, does not look
    with pytest.raises(ValueError, match="crc mismatch"):
        tb.read_bundle(prefix, verify=True)
    index = bytearray(open(prefix + ".index", "rb").read())
    index[10] ^= 0xFF  # inside the data block
    open(prefix + ".index", "wb").write(bytes(index))
    with pytest.raises(ValueError, match="block crc mismatch"):
        tb.read_bundle(prefix, verify=True)
    open(prefix + ".index", "wb").write(b"junk")
    with pytest.raises(ValueError):
        tb.read_bundle(prefix)


def test_bundle_proto_and_snappy_decoders():
    # TensorShapeProto{dim: [Dim{}, Dim{size: 3}]}: an omitted size is 0
    assert tb._parse_shape(bytes([0x12, 0x00, 0x12, 0x02, 0x08, 0x03])) == (0, 3)
    payload = b"abcdefgh" * 7
    lit = bytes([(len(payload) - 1) << 2]) + payload
    copy1 = bytes([((8 - 4) << 2) | 1, 8])
    copy2 = bytes([((20 - 1) << 2) | 2]) + (16).to_bytes(2, "little")
    copy4 = bytes([((5 - 1) << 2) | 3]) + (3).to_bytes(4, "little")
    src = tb._write_varint(len(payload) + 8 + 20 + 5) + lit + copy1 + copy2 + copy4
    out = tb._snappy_decode(src)
    assert out == jtb._snappy_decode(src)
    ref = bytearray(payload)
    for ln, off in ((8, 8), (20, 16), (5, 3)):
        for _ in range(ln):
            ref.append(ref[-off])
    assert out == bytes(ref)


def test_bundle_bf16_without_ml_dtypes_names_the_dtype(tmp_path):
    import ml_dtypes

    prefix = str(tmp_path / "bf")
    tb.write_bundle(prefix, {"w": np.ones(3, ml_dtypes.bfloat16)})
    code = ("import sys\nsys.modules['ml_dtypes'] = None\n"
            "from fisr_tpu_torch.convert import tensor_bundle as tb\n"
            f"tb.read_bundle({prefix!r})\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode != 0 and "ValueError: w: dtype bfloat16" in proc.stderr


# ---- TF1 import ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """A full-width FISRnet and a PWC-Net bundle in TF's names, with the
    optimizer slots and bookkeeping that TF1 train checkpoints carry."""
    d = tmp_path_factory.mktemp("bundles")
    out = {}
    for model, make, export in (
            ("fisrnet", lambda: fisrnet.FISRnet(seed=3, device="cpu"), tf_import.export_fisrnet),
            ("pwcnet", lambda: params.deterministic_pwcnet(device="cpu"), tf_import.export_pwcnet)):
        tree = params.to_jax_tree(make())
        tf_vars = export(tree)
        first = next(iter(tf_vars))
        tf_vars.update({first + "/Adam": np.zeros(3, np.float32),
                        first + "/Adam_1": np.zeros(3, np.float32),
                        "beta1_power": np.float32(0.9).reshape(()),
                        "global_step": np.int64(122000).reshape(())})
        prefix = str(d / f"{model}.ckpt-122000")
        tb.write_bundle(prefix, tf_vars, crc=False)
        out[model] = (prefix, tree)
    return out


def test_tf_import_fisrnet_matches_the_jax_import_and_apply(bundles):
    prefix, tree = bundles["fisrnet"]
    ours = tf_import.load_tf_checkpoint(prefix, "fisrnet")
    theirs = jtf.load_tf_checkpoint(prefix, "fisrnet")
    _assert_trees_equal(ours, jax.tree_util.tree_map(np.asarray, theirs))
    _assert_trees_equal(ours, tree)
    x = np.random.default_rng(0).uniform(size=(1, 16, 16, 29)).astype(np.float32)
    want = np.asarray(jax.jit(jfisrnet.apply)(theirs, jnp.asarray(x))[2])
    with torch.no_grad():
        got = fisrnet.apply(params.fisrnet_from_jax(ours, device="cpu"),
                            torch.from_numpy(x))[2].numpy()
    assert got.shape == want.shape == (1, 32, 32, 9)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_tf_import_pwcnet_matches_the_jax_import_and_apply(bundles):
    prefix, tree = bundles["pwcnet"]
    ours = tf_import.load_tf_checkpoint(prefix, "pwcnet", verify_crc=True)
    theirs = jtf.load_tf_checkpoint(prefix, "pwcnet")
    _assert_trees_equal(ours, jax.tree_util.tree_map(np.asarray, theirs))
    _assert_trees_equal(ours, tree)
    rng = np.random.default_rng(1)
    x1 = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    x2 = np.roll(x1, (1, 2), axis=(1, 2))
    want = np.asarray(jpwcnet.apply(theirs, jnp.asarray(x1), jnp.asarray(x2))[0])
    model = params.pwcnet_from_jax(ours, device="cpu")
    with torch.no_grad():
        got = pwcnet.apply(model, torch.from_numpy(x1), torch.from_numpy(x2), model.cfg)[0].numpy()
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_tf_import_rejects_missing_and_misshapen_variables(tmp_path, bundles):
    prefix, _ = bundles["pwcnet"]
    tf_vars = tb.read_bundle(prefix)
    missing = dict(tf_vars)
    missing.pop("pwcnet/featpyr/conv1a/kernel")
    tb.write_bundle(str(tmp_path / "missing"), missing, crc=False)
    with pytest.raises(KeyError, match="missing from the checkpoint"):
        tf_import.load_tf_checkpoint(str(tmp_path / "missing"), "pwcnet")
    bad = dict(tf_vars, **{"pwcnet/featpyr/conv1a/kernel": np.zeros((3, 3, 3, 8), np.float32)})
    tb.write_bundle(str(tmp_path / "bad"), bad, crc=False)
    with pytest.raises(ValueError, match="shape mismatch at feat/level_1/a/w"):
        tf_import.load_tf_checkpoint(str(tmp_path / "bad"), "pwcnet")
    with pytest.raises(ValueError, match="unknown model"):
        tf_import.load_tf_checkpoint(prefix, "resnet")
    assert set(tf_import.normalize_tf_vars({"x/w:0": 1, "x/w/Adam": 2, "global_step": 3})) == {"x/w"}


# ---- convert.cli --------------------------------------------------------------------

@pytest.mark.parametrize("source", ["ckpt", "npz", "orbax"])
def test_convert_cli_round_trips(tmp_path, bundles, capsys, source):
    from fisr_tpu_torch.convert.cli import main as convert_main

    prefix, tree = bundles["pwcnet"]
    if source == "ckpt":
        arg = prefix
    elif source == "npz":
        arg = str(tmp_path / "w.npz")
        np.savez(arg, **{k + ":0": v for k, v in tb.read_bundle(prefix).items()})
    else:
        JaxCheckpointManager(str(tmp_path / "jax")).save(
            14000, {"params": tree, "step": np.asarray(14000, np.int32)})
        arg = str(tmp_path / "jax" / "step_14000")
    out = str(tmp_path / "port")
    convert_main(["--model", "pwcnet", f"--{source}", arg, "--out", out, "--step", "122000"])
    assert f"[*] wrote step 122000 (" in capsys.readouterr().out
    mgr = CheckpointManager(out)
    assert mgr.latest_step() == 122000
    assert os.listdir(os.path.join(out, "step_122000")) == ["tree.npz"]
    _assert_trees_equal(mgr.restore()["params"], tree)
    # a PWC-Net is not a FISRnet: missing variables (TF sources) or keys (orbax)
    with pytest.raises((KeyError, ValueError), match="missing"):
        convert_main(["--model", "fisrnet", f"--{source}", arg, "--out", out])
