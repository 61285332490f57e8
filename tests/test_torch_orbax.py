"""Port: the orbax reader without tensorstore (convert/ocdbt.py, the zarr v2
arrays and read_orbax_tree in convert/orbax_read.py) against tensorstore's
own read, on the CPU.

Held bit-equal (keys, values, dtypes, shapes) to tensorstore on the repo's
three orbax steps (checkpoint_dir/pwcnet/step_14000 and
pwcnet_joint{,_fast}/step_1000, storage only: their model layout is stale),
on steps the JAX package's CheckpointManager writes here (f32, an int32
scalar and bfloat16 leaves), and on stores written here through
tensorstore's ocdbt and zarr drivers: a B-tree with interior nodes (a
1024-byte node limit over thousands of keys), more versions than the
manifest holds (version-tree nodes), uncompressed nodes, arrays of every
dtype the reader takes with edge chunks, missing chunks and fill values.
What it does not take is refused by name (a numbered manifest, a zarr v3
array, a filter, order F); a flipped byte or a truncated file raises
ValueError naming the file. The SHA-256 of the trained tree that
chip_smoke.py checks on the card is pinned here against tensorstore's read,
and the CLI's default PWC-Net restore runs with tensorstore and zstandard
unimportable.
"""

import os
import shutil
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import tensorstore as ts
import torch

from fisr_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.convert.ocdbt import OcdbtStore
from fisr_tpu_torch.convert.orbax_read import read_orbax_tree, read_zarr_arrays, tree_digest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = {"pwcnet": "step_14000", "pwcnet_joint": "step_1000", "pwcnet_joint_fast": "step_1000"}
# the dtype of every leaf each step stores
STEP_DTYPES = {"pwcnet": np.float32, "pwcnet_joint": ml_dtypes.bfloat16,
               "pwcnet_joint_fast": ml_dtypes.bfloat16}
# SHA-256 of checkpoint_dir/pwcnet/step_14000's tree (orbax_read.tree_digest):
# chip_smoke.py holds the card's read against it
TRAINED_SHA256 = "9e18a0b4d1fe2298769497502125336b1dfc0df871809ce8d380e6b7f04d597f"


def _step(name):
    return os.path.join(ROOT, "checkpoint_dir", name, STEPS[name])


def _ts_kv(root):
    return ts.KvStore.open({"driver": "ocdbt", "base": "file://" + root}).result()


def _ts_array(root, name):
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": "file://" + root,
                                          "path": name}}
    return ts.open(spec, open=True, read=True).result().read().result()


def _ts_tree(step_dir):
    """tensorstore's read of an orbax step: each leaf of _METADATA opened
    through its zarr and ocdbt drivers."""
    import json

    from fisr_tpu_torch.convert.orbax_read import _nest

    with open(os.path.join(step_dir, "_METADATA")) as f:
        meta = json.load(f)["tree_metadata"]
    leaves = []
    for entry in meta.values():
        keys = entry["key_metadata"]
        leaves.append((keys, np.asarray(_ts_array(step_dir, ".".join(str(k["key"])
                                                                    for k in keys)))))
    return _nest(leaves)


def _assert_store_equal(root):
    store = OcdbtStore(root)
    kv = _ts_kv(root)
    want = sorted(k.decode() for k in kv.list().result())
    assert store.keys() == want
    got = dict(store.items())
    assert list(got) == want
    for key in want:
        assert got[key] == kv.read(key).result().value, key
        assert store.read(key) == got[key]
    assert store.read("no/such/key") is None
    return store


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_trees_equal(got, want, path=()):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], path + (k,))
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, path + (i,))
    else:
        w = np.asarray(want)
        assert got.dtype == w.dtype and got.shape == w.shape, (path, got.dtype, w.dtype)
        np.testing.assert_array_equal(_bits(got), _bits(w), err_msg=str(path))


# ---- the repo's orbax steps --------------------------------------------------

@pytest.mark.parametrize("name", sorted(STEPS))
def test_repo_steps_read_bit_equal_to_tensorstore(name):
    store = _assert_store_equal(_step(name))
    assert store.generation == 1 and store.root_height == 0 and len(store.keys()) == 364
    tree = read_orbax_tree(_step(name))
    _assert_trees_equal(tree, _ts_tree(_step(name)))
    leaves = list(params.flatten_tree(tree["params"]))
    assert len(leaves) == 182 and {a.dtype for _, a in leaves} == {np.dtype(STEP_DTYPES[name])}


def test_trained_digest_is_pinned_here_and_in_chip_smoke():
    want = tree_digest(_ts_tree(_step("pwcnet")))
    assert want == TRAINED_SHA256
    assert tree_digest(read_orbax_tree(_step("pwcnet"))) == TRAINED_SHA256
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        assert f'TRAINED_PWC_SHA256 = "{TRAINED_SHA256}"' in f.read()
    # the digest sees each leaf's path, dtype, shape and bytes
    tree = {"a": np.zeros((2, 3), np.float32), "b": [np.int32(7)]}
    base = tree_digest(tree)
    for other in ({"a": np.zeros((3, 2), np.float32), "b": [np.int32(7)]},
                  {"a": np.zeros((2, 3), np.float64), "b": [np.int32(7)]},
                  {"c": np.zeros((2, 3), np.float32), "b": [np.int32(7)]},
                  {"a": np.zeros((2, 3), np.float32), "b": [np.int32(8)]}):
        assert tree_digest(other) != base


# ---- steps the JAX CheckpointManager writes here --------------------------------

def test_jax_manager_steps_with_scalar_and_bfloat16_leaves(tmp_path):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    tree = {"params": {"w": jnp.asarray(rng.standard_normal((5, 7)), jnp.float32),
                       "h": jnp.asarray(rng.standard_normal((3, 4, 6)), jnp.bfloat16),
                       "layers": [{"b": jnp.zeros(3, jnp.float32)},
                                  {"b": jnp.asarray(rng.standard_normal(9), jnp.bfloat16)}]},
            "step": jnp.asarray(11, jnp.int32)}
    mgr = JaxCheckpointManager(str(tmp_path), max_to_keep=3)
    for step in (1, 2):
        mgr.save(step, tree)
    for step in (1, 2):
        step_dir = str(tmp_path / f"step_{step}")
        _assert_store_equal(step_dir)
        got = read_orbax_tree(step_dir)
        _assert_trees_equal(got, _ts_tree(step_dir))
        _assert_trees_equal(got, JaxCheckpointManager(str(tmp_path)).restore(step))
        assert got["step"].shape == () and got["step"].dtype == np.int32
        assert got["params"]["h"].dtype == ml_dtypes.bfloat16


# ---- stores written through tensorstore's drivers ---------------------------------

def _zarr(root, name, dtype, shape, chunks, config, fill=None, sep=".", zstd=True):
    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": "file://" + root, "path": name,
                        "config": config},
            "metadata": {"dtype": dtype, "shape": shape, "chunks": chunks, "fill_value": fill,
                         "dimension_separator": sep,
                         "compressor": {"id": "zstd", "level": 3} if zstd else None}}
    return ts.open(spec, create=True).result()


def _write_arrays(root, config):
    """Arrays of every dtype the reader takes, with edge chunks, missing chunks
    and fill values, each written in its own commits."""
    rng = np.random.default_rng(3)
    a = _zarr(root, "a", "<f4", [37, 50], [8, 16], config)
    a[5:30, 10:45] = rng.standard_normal((25, 35)).astype(np.float32)  # chunks missing
    _zarr(root, "b", "bfloat16", [20], [6], config, fill=1.5, sep="/")[:7] = (
        rng.standard_normal(7).astype(ml_dtypes.bfloat16))
    _zarr(root, "c", "|b1", [9, 9], [4, 4], config, zstd=False)[...] = np.eye(9) > 0
    _zarr(root, "d", "<f8", [3, 4, 5], [2, 3, 2], config, fill="NaN")[1:, :2, 1:4] = 2.25
    _zarr(root, "e", "<f2", [11], [4], config)[...] = (np.arange(11) / 3).astype(np.float16)
    _zarr(root, "f", "<i4", [], [], config)[...] = np.int32(-7)
    _zarr(root, "g", "<u1", [300], [7], config, fill=9)[40:250] = np.arange(210, dtype=np.uint8)
    _zarr(root, "h", "<f4", [5], [5], config, zstd=False)[...] = np.arange(5, dtype=np.float32)
    for v in range(12):  # more keys and versions
        _zarr(root, f"many/x{v}", "<i8", [300], [3], config)[...] = np.arange(300) * v
    return ["a", "b", "c", "d", "e", "f", "g", "h"] + [f"many/x{v}" for v in range(12)]


@pytest.mark.parametrize("kind", ["interior_nodes_and_version_tree", "uncompressed"])
def test_tensorstore_written_stores_read_bit_equal(tmp_path, kind):
    root = str(tmp_path / kind)
    if kind == "uncompressed":
        config = {"compression": None, "max_decoded_node_bytes": 1024}
    else:
        config = {"max_decoded_node_bytes": 1024, "max_inline_value_bytes": 64,
                  "version_tree_arity_log2": 2, "compression": {"id": "zstd", "level": 5}}
    names = _write_arrays(root, config)
    store = _assert_store_equal(root)
    got = read_zarr_arrays(store, names)
    for name, a in zip(names, got):
        assert a.flags.writeable, name
        want = np.asarray(_ts_array(root, name))
        assert a.dtype == want.dtype and a.shape == want.shape, name
        np.testing.assert_array_equal(_bits(a), _bits(want), err_msg=name)
    manifest = ts.ocdbt.dump(ts.KvStore.open("file://" + root + "/").result()).result()
    if kind == "uncompressed":
        assert manifest["config"]["compression"] is None and "zstd_level" not in store.config
        assert store.root_height >= 1
    else:
        assert store.root_height >= 2 and len(store.keys()) > 1000
        assert manifest["version_tree_nodes"], "no version-tree nodes"
        assert store.generation == max(v["generation_number"] for v in manifest["versions"])


def test_thousands_of_keys_under_a_small_node_limit(tmp_path):
    root = str(tmp_path / "kv")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + root,
                          "config": {"max_decoded_node_bytes": 512,
                                     "max_inline_value_bytes": 16,
                                     "version_tree_arity_log2": 1}}).result()
    rng = np.random.default_rng(5)
    for v in range(9):
        with ts.Transaction() as txn:
            for i in range(400):
                kv.with_transaction(txn)[f"grp{v % 3}/k{i:04d}_{v}"] = rng.bytes(
                    int(rng.integers(0, 40)))
    del kv["grp0/k0000_0"]
    store = _assert_store_equal(root)
    assert store.root_height >= 3 and len(store.keys()) == 9 * 400 - 1
    assert [k for k, _ in store.items("grp1/k0001")] == ["grp1/k0001_1", "grp1/k0001_4",
                                                         "grp1/k0001_7"]


def test_empty_store(tmp_path):
    root = str(tmp_path / "empty")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + root}).result()
    kv["a"] = b"1"
    del kv["a"]
    store = _assert_store_equal(root)
    assert store.keys() == [] and list(store.items()) == []


# ---- refusals and errors ---------------------------------------------------------

def test_refusals_name_what_they_refuse(tmp_path):
    numbered = str(tmp_path / "numbered")
    ts.KvStore.open({"driver": "ocdbt", "base": "file://" + numbered,
                     "config": {"manifest_kind": "numbered"}}).result()["a"] = b"1"
    with pytest.raises(NotImplementedError, match="manifest kind 1"):
        OcdbtStore(numbered)
    root = str(tmp_path / "zarr")
    spec = {"driver": "zarr3", "kvstore": {"driver": "ocdbt", "base": "file://" + root,
                                           "path": "v3"},
            "metadata": {"data_type": "float32", "shape": [4]}}
    ts.open(spec, create=True).result()[...] = np.arange(4, dtype=np.float32)
    kv = _ts_kv(root)
    meta = ('{"chunks":[4],"compressor":null,"dtype":"<f4","fill_value":null,"filters":%s,'
            '"order":"%s","shape":[4],"zarr_format":2}')
    kv["filtered/.zarray"] = meta % ('[{"id":"delta","dtype":"<f4"}]', "C")
    kv["fortran/.zarray"] = meta % ("null", "F")
    kv["lz4/.zarray"] = meta.replace('"compressor":null', '"compressor":{"id":"lz4"}') % (
        "null", "C")
    kv["complex/.zarray"] = meta.replace("<f4", "<c8") % ("null", "C")
    store = OcdbtStore(root)
    for name, match in (("v3", r"zarr v3 array \(zarr.json\)"),
                        ("filtered", "filters .*delta"), ("fortran", "order 'F'"),
                        ("lz4", "compressor 'lz4'"), ("complex", "zarr dtype '<c8'")):
        with pytest.raises(NotImplementedError, match=match):
            read_zarr_arrays(store, [name])
    with pytest.raises(FileNotFoundError, match="no none/.zarray"):
        read_zarr_arrays(store, ["none"])


def test_a_flipped_or_truncated_file_names_the_file(tmp_path):
    root = str(tmp_path / "store")
    shutil.copytree(_step("pwcnet_joint"), root)
    node = os.path.join(root, "d", os.listdir(os.path.join(root, "d"))[0])
    data = bytearray(open(node, "rb").read())
    data[len(data) // 2] ^= 0x10
    with open(node, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=rf"{node} .*crc32c mismatch"):
        OcdbtStore(root).keys()
    with open(node, "wb") as f:
        f.write(data[:len(data) - 100])
    with pytest.raises(ValueError, match=rf"{node} .*truncated"):
        OcdbtStore(root).keys()
    manifest = os.path.join(root, "manifest.ocdbt")
    data = bytearray(open(manifest, "rb").read())
    data[20] ^= 1
    with open(manifest, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=rf"{manifest}: crc32c mismatch"):
        OcdbtStore(root)
    # a value's data file cut short: the read names it
    root = str(tmp_path / "values")
    shutil.copytree(_step("pwcnet_joint"), root)
    big = max((os.path.join(root, "ocdbt.process_0", "d", n)
               for n in os.listdir(os.path.join(root, "ocdbt.process_0", "d"))),
              key=os.path.getsize)
    os.truncate(big, os.path.getsize(big) // 2)
    with pytest.raises(ValueError, match=rf"{big} .*truncated"):
        read_orbax_tree(root)


# ---- without tensorstore and zstandard --------------------------------------------

def test_cli_default_restore_without_tensorstore_or_zstandard(tmp_path):
    """The CLI's default PWC-Net restore (checkpoint_dir/pwcnet) with
    tensorstore and zstandard unimportable: the same state-dict tensors as the
    model built from tensorstore's read."""
    out = tmp_path / "state.pt"
    code = (
        "import sys, torch\n"
        "sys.modules['tensorstore'] = None\n"
        "sys.modules['zstandard'] = None\n"
        "from fisr_tpu_torch.cli import main as cli\n"
        "m = cli._model(cli.parse_args(['--device', 'cpu']), 'cpu', 'pwc')\n"
        f"torch.save(m.state_dict(), {str(out)!r})\n"
        "assert 'tensorstore' not in [k for k, v in sys.modules.items() if v is not None]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert " [*] restored PWC-Net checkpoint step 14000 from " in proc.stdout
    got = torch.load(out)
    want = params.pwcnet_from_jax(_ts_tree(_step("pwcnet"))["params"], device="cpu").state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
