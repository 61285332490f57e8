"""Port: the HDF5 codec behind the .mat files (data/hdf5, data/matio)
against h5py and the JAX package's matio.

Every file here is written by h5py (HDF5 1.14 at h5py's defaults, libver
'earliest') in the layouts the reference's writers use: MATLAB's save -v7.3,
hdf5storage's matlab_compatible (gzip 7 + shuffle + fletcher32, automatic
chunks) and h5py itself. The port's reader must return every dataset and
attribute bit for bit as h5py reads them, and refuse what it does not
implement with NotImplementedError naming it. The port's writer's files must
read back exactly through h5py and the JAX readers; the JAX writer's through
the port's. The corpus and test-set path runs in a process where h5py
cannot be imported.
"""

import json
import os
import struct
import subprocess
import sys

import h5py
import numpy as np
import pytest

from fisr_tpu.data import dataset as jdataset
from fisr_tpu.data import matio as jmatio
from fisr_tpu_torch.data import hdf5, matio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _array(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        a = rng.normal(scale=100.0, size=shape).astype(dt)
        if a.size:
            a.flat[0] = np.nan  # NaN and infinities keep their bits
            a.flat[-1] = -np.inf
        return a
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=shape, endpoint=True,
                        dtype=dt.newbyteorder("=")).astype(dt)


def _one(shape, dtype="<f4", userblock=0, **kw):
    def build(path):
        with h5py.File(path, "w", userblock_size=userblock) as f:
            f.create_dataset("x", data=_array(shape, dtype), **kw)
    return build


def _many(n):
    def build(path):
        with h5py.File(path, "w") as f:
            for i in range(n):
                f.create_dataset(f"d{i:03d}", data=_array((2, i % 3 + 1), "<f4", seed=i))
    return build


def _attributes(path):
    """More attributes than the first object header chunk holds."""
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("x", data=_array((4, 3), "<f8"))
        ds.attrs.create("MATLAB_class", np.bytes_(b"double"))
        for i in range(30):
            ds.attrs[f"scalar_{i:02d}"] = np.int32(i - 7)
            ds.attrs[f"vector_{i:02d}"] = _array((i % 4 + 1,), "<f4", seed=i)
            ds.attrs[f"text_{i:02d}"] = np.bytes_(b"t" * (i + 1))
        ds.attrs["strings"] = np.array([b"ab", b"cde"], dtype="S3")
        assert h5py.h5o.get_info(ds.id).hdr.nchunks > 1


def _unwritten(path):
    """Chunked datasets with chunks never written: the fill value there."""
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("x", shape=(20, 23), dtype="<f4", chunks=(5, 6), fillvalue=-3.5)
        ds[0:5, 0:10] = _array((5, 10), "<f4")
        ds[15:20, 17:23] = _array((5, 6), "<f4", seed=1)
        f.create_dataset("none", shape=(7, 9), dtype="<i2", chunks=(4, 4), fillvalue=11)
        f.create_dataset("gz", shape=(9, 9), dtype="<u2", chunks=(4, 4), fillvalue=9,
                         compression="gzip", shuffle=True, fletcher32=True)[0:4, 0:4] = 3
        f.create_dataset("contiguous", shape=(3, 4), dtype="<f8", fillvalue=7.25)
        f.create_dataset("zero_fill", shape=(6, 5), dtype="<f4", chunks=(4, 4))


def _skipped_filter(path):
    """A chunk the writer stored with deflate skipped (filter mask bit 1):
    only the shuffle is undone there."""
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("x", shape=(8, 8), dtype="<i4", chunks=(4, 8), compression="gzip",
                              shuffle=True)
        ds[0:4] = _array((4, 8), "<i4")
        raw = _array((4, 8), "<i4", seed=2)
        shuffled = raw.view(np.uint8).reshape(-1, 4).T.tobytes()
        ds.id.write_direct_chunk((4, 0), shuffled, filter_mask=0b10)


def _compact(path):
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        data = _array((5, 6), "<i4")
        space = h5py.h5s.create_simple(data.shape)
        h5py.h5d.create(f.id, b"x", h5py.h5t.STD_I32LE, space, dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, data)


def _subgroup(path):
    """A nested group, as MATLAB's #refs# for cells and structs."""
    with h5py.File(path, "w", userblock_size=512) as f:
        f.create_dataset("x", data=_array((3, 2), "<f8"))
        g = f.create_group("#refs#")
        g.create_dataset("a", data=_array((4,), "<u1"))
        g.create_group("inner").create_dataset("b", data=_array((2, 2), ">i4"),
                                               chunks=(1, 2), compression="gzip")


# gzip levels 1, 4 and 9, each alone and with shuffle, fletcher32 or both;
# and shuffle and fletcher32 without gzip
FILTERS = {
    "_".join(k for k in (f"gzip{level}" if level else "", "shuffle" * shuffle,
                         "fletcher32" * fletcher) if k):
    dict(compression="gzip" if level else None, compression_opts=level or None,
         shuffle=shuffle, fletcher32=fletcher)
    for level in (0, 1, 4, 9) for shuffle in (False, True) for fletcher in (False, True)
    if level or shuffle or fletcher}
CASES = {
    **{f"dtype_{d}": _one((4, 5, 6), d) for d in ("u1", "i2", "u2", "i4", "f4", "f8")},
    "dtype_f4_big_endian": _one((4, 5, 6), ">f4"),
    "dtype_i2_big_endian_chunked": _one((9, 7), ">i2", chunks=(4, 3), shuffle=True),
    **{f"rank{r}": _one((3, 4, 2, 5, 2)[:r]) for r in range(6)},
    "size0_contiguous": _one((3, 0, 2)),
    "size0_chunked": _one((0, 4), chunks=(2, 2), maxshape=(None, 4)),
    "contiguous": _one((7, 11, 3)),
    "chunked_edges": _one((10, 13, 3), chunks=(4, 5, 2)),
    "chunked_edges_u1": _one((10, 13, 3), "u1", chunks=(3, 3, 3)),
    **{f"{k}_edges": _one((37, 29), chunks=(8, 8), **v) for k, v in FILTERS.items()},
    "fletcher32_odd_bytes": _one((5, 7), "u1", chunks=(3, 3), fletcher32=True),
    # hdf5storage's matlab_compatible: column-major [3, W, H, 8, N] warp stacks
    "hdf5storage": _one((3, 40, 30, 8, 2), compression="gzip", compression_opts=7,
                        shuffle=True, fletcher32=True, chunks=True),
    "userblock0": _one((6, 5)),
    "userblock512": _one((6, 5), userblock=512),
    "userblock2048": _one((6, 5), userblock=2048, chunks=(2, 2), compression="gzip"),
    "root_40": _many(40),
    "root_200_btree_split": _many(200),
    "attributes_continuation": _attributes,
    "unwritten_chunks": _unwritten,
    "filter_skipped_in_one_chunk": _skipped_filter,
    "compact": _compact,
    "subgroup": _subgroup,
}


def _assert_same(ours, theirs):
    assert ours.keys() == sorted(theirs.keys(), key=str.encode)
    for k in theirs:
        want = theirs[k]
        if isinstance(want, h5py.Group):
            _assert_same(ours[k], want)
            continue
        got = ours[k]
        data = np.asarray(want[()])
        out = got.read()
        assert got.shape == data.shape == out.shape and got.dtype == data.dtype == out.dtype
        assert out.tobytes() == data.tobytes(), k
        attrs, want_attrs = got.attrs, dict(want.attrs)
        assert sorted(attrs) == sorted(want_attrs)
        for a, v in want_attrs.items():
            assert type(attrs[a]) is type(v), a
            assert np.asarray(attrs[a]).dtype == np.asarray(v).dtype, a
            assert np.asarray(attrs[a]).tobytes() == np.asarray(v).tobytes(), a


@pytest.mark.parametrize("case", sorted(CASES))
def test_reads_h5py_files_bit_for_bit(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    CASES[case](path)
    with h5py.File(path, "r") as theirs, hdf5.File(path) as ours:
        _assert_same(ours, theirs)
    if case == "root_200_btree_split":
        # the root group's B-tree (its address in the superblock's root
        # entry scratch pad) has grown a level: its node level is not 0
        raw = open(path, "rb").read()
        btree = struct.unpack_from("<Q", raw, 80)[0]
        assert raw[btree:btree + 4] == b"TREE" and raw[btree + 5] >= 1


def _latest(path):
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.zeros(3, np.float32)


def _ohdr2(path):
    """A dataset added to an old-format file opened with libver='latest'."""
    with h5py.File(path, "w") as f:
        f["old"] = np.zeros(3, np.float32)
    with h5py.File(path, "r+", libver="latest") as f:
        f.create_dataset("x", data=np.zeros(5, np.float32), chunks=(2,), maxshape=(None,))


def _committed(path):
    with h5py.File(path, "w") as f:
        f["t"] = np.dtype("<f4")
        f.create_dataset("x", data=np.zeros(3, np.float32), dtype=f["t"])


def _vlen(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=["ab", "cde"], dtype=h5py.string_dtype())


def _lzf(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.zeros((8, 8), np.float32), compression="lzf")


def _scaleoffset(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.zeros((8, 8), np.int32), scaleoffset=0)


REFUSALS = {"libver_latest": (_latest, "superblock version 3"),
            "object_header_v2": (_ohdr2, "object header version 2"),
            "committed_datatype": (_committed, "committed datatype"),
            "variable_length": (_vlen, r"datatype class 9 \(variable-length\)"),
            "lzf": (_lzf, r"filter 32000 \(lzf\)"),
            "scaleoffset": (_scaleoffset, r"filter 6 \(scaleoffset\)")}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refuses_what_it_does_not_implement(tmp_path, case):
    build, feature = REFUSALS[case]
    path = str(tmp_path / "f.h5")
    build(path)
    with pytest.raises(NotImplementedError, match=feature):
        with hdf5.File(path) as f:
            f["x"].read()


def test_refuses_a_corrupt_fletcher32_chunk_and_a_non_hdf5_file(tmp_path):
    path = str(tmp_path / "f.h5")
    _one((16, 16), chunks=(8, 8), fletcher32=True)(path)
    with h5py.File(path, "r") as f:
        offset = f["x"].id.get_chunk_info(1).byte_offset
    raw = bytearray(open(path, "rb").read())
    raw[offset + 5] ^= 0x10
    open(path, "wb").write(bytes(raw))
    with hdf5.File(path) as f:
        with pytest.raises(ValueError, match="fletcher32 checksum mismatch"):
            f["x"].read()
    with pytest.raises(OSError):  # h5py refuses it too
        with h5py.File(path, "r") as f:
            f["x"][()]
    (tmp_path / "text.mat").write_bytes(b"MATLAB 5.0 MAT-file" + bytes(2000))
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(str(tmp_path / "text.mat"))


def test_fletcher32_matches_the_c_loop():
    """The closed form against HDF5's loop (H5_checksum_fletcher32),
    transcribed: 360-word blocks, end-around carry, odd trailing byte."""
    def loop(data):
        s1 = s2 = 0
        words = len(data) // 2
        i = 0
        while words:
            t = min(words, 360)
            words -= t
            for _ in range(t):
                s1 += data[i] << 8 | data[i + 1]
                i += 2
                s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        if len(data) % 2:
            s1 += data[i] << 8
            s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
        return s2 << 16 | s1

    rng = np.random.default_rng(0)
    cases = [b"", b"\0" * 10, b"\xff" * 4000, b"\x01", bytes(range(256)) * 11]
    cases += [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (1, 2, 719, 720, 721, 5001)]
    for data in cases:
        assert hdf5._fletcher32(data) == loop(data), len(data)


WRITES = {"rank5": ((2, 3, 4, 5, 3), None),
          "transposed_in_slabs": ((3, 9, 7, 8, 2), (4, 3, 2, 1, 0)),
          "swapped_in_slabs": ((2, 5, 3, 9, 7), (0, 1, 4, 3, 2)),
          "size0": ((2, 0, 3), None),
          "scalar": ((), None)}


@pytest.mark.parametrize("case", sorted(WRITES))
def test_writer_files_read_back_through_h5py(tmp_path, monkeypatch, case):
    """h5py reads the writer's datasets and MATLAB_class attributes exactly;
    a non-contiguous array goes out in slabs (a small bound forces many)."""
    monkeypatch.setattr(hdf5, "_STREAM_BYTES", 256)
    shape, axes = WRITES[case]
    a = _array(shape, "<f4", seed=3)
    a = a if axes is None else np.transpose(a.reshape([shape[i] for i in np.argsort(axes)]), axes)
    assert axes is None or not a.flags.c_contiguous
    extra = np.arange(6, dtype=np.float32).reshape(2, 3)
    path = str(tmp_path / "w.mat")
    hdf5.write(path, {"pred": a, "aux": extra}, attrs={"MATLAB_class": b"single"},
               userblock=b"MATLAB 7.3 MAT-file")
    with h5py.File(path, "r") as f:
        assert sorted(f) == ["aux", "pred"] and f.userblock_size == 512
        for key, want in (("pred", a), ("aux", extra)):
            got = np.asarray(f[key][()])
            assert got.dtype == np.dtype("<f4") and got.shape == want.shape
            assert got.tobytes() == np.ascontiguousarray(want).tobytes()
            cls = f[key].attrs["MATLAB_class"]
            assert cls == np.bytes_(b"single") and np.asarray(cls).dtype == np.dtype("S6")
    with hdf5.File(path) as f:
        assert f["pred"].read().tobytes() == np.ascontiguousarray(a).tobytes()
    with pytest.raises(TypeError, match="float32"):
        hdf5.write(path, {"x": np.zeros(3)})


def test_matio_files_carry_the_matlab_header(tmp_path):
    """The first 128 bytes: the header text padded to 116, 8 bytes of
    subsystem offset, version 0x0200 and 'IM'; the rest of the 512-byte
    userblock as the JAX writer leaves it."""
    warps = _array((1, 8, 6, 9, 3), "<f4")
    matio.write_warp_mat(warps, tmp_path / "port.mat")
    jmatio.write_warp_mat(warps, tmp_path / "jax.mat")
    port, jax = (open(tmp_path / n, "rb").read(512) for n in ("port.mat", "jax.mat"))
    assert port[:116] == b"MATLAB 7.3 MAT-file, Platform: GLNXA64, Created by: fisr_tpu_torch".ljust(116)
    assert port[116:128] == bytes(8) + b"\x00\x02IM"
    assert port[:19] == jax[:19] and port[116:] == jax[116:]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_matio_cross_reads_exactly(tmp_path, writer):
    """The JAX readers read the port's files and the port's readers the JAX
    writer's, exactly; the arrays are larger than the readers' buffers."""
    w = matio if writer == "port" else jmatio
    rng = np.random.default_rng(5)
    warps = rng.uniform(0, 255, size=(3, 8, 40, 56, 3)).astype(np.float32)
    train = rng.integers(0, 256, size=(3, 5, 40, 56, 3)).astype(np.float32)
    w.write_warp_mat(warps, tmp_path / "w.mat")
    w.write_train_mat(tmp_path / "t.mat", "HR_data", train)
    for r in (matio, jmatio):
        np.testing.assert_array_equal(r.read_warp_mat(tmp_path / "w.mat"), warps / np.float32(255))
        np.testing.assert_array_equal(r.read_train_mat(tmp_path / "t.mat", "HR_data"),
                                      train / np.float32(255))


def test_file_backed_store_gathers_without_copying_the_store(tmp_path, monkeypatch):
    """TrainStore.from_files holds C-contiguous arrays, so a batch gathers
    its rows alone: the train readers return axis-swapped views, and a view
    made the gather copy the whole split on every batch (on an H100 a bf16
    step fed from a 48-sample file-backed store took 215 ms against 124 ms
    from the in-memory store)."""
    from fisr_tpu_torch.data import dataset, synth

    paths = synth.write_synthetic_corpus(str(tmp_path), n_samples=6, h=16, w=16)
    store = dataset.TrainStore.from_files(**paths, val_size=2)
    copied = []
    real = np.ascontiguousarray

    def spy(a, *args, **kw):
        if not np.asarray(a).flags.c_contiguous:
            copied.append(np.asarray(a).shape)
        return real(a, *args, **kw)

    monkeypatch.setattr(np, "ascontiguousarray", spy)
    batch = next(store.batches(2, epoch_seed=0))
    assert not copied
    want = jdataset.TrainStore.from_files(**paths, val_size=2)
    idx = np.random.default_rng(0).permutation(4)[:2]
    for k, v in batch.items():
        assert getattr(store, k).flags.c_contiguous
        np.testing.assert_array_equal(v, getattr(want, k)[idx])


_NO_H5PY = """
import json, sys
sys.modules["h5py"] = None
import numpy as np
import torch
from fisr_tpu_torch.cli.main import main
from fisr_tpu_torch.convert import params
from fisr_tpu_torch.data import synth
from fisr_tpu_torch.data.dataset import TrainStore
from fisr_tpu_torch.infer.evaluate import evaluate_test_set
from fisr_tpu_torch.infer.tiled import TiledRunner
from fisr_tpu_torch.ops.conv import F32

torch.set_num_threads(2)
out = sys.argv[1]
corpus = synth.write_synthetic_corpus(out + "/train", n_samples=4, h=32, w=32)
store = TrainStore.from_files(**corpus, val_size=2)
np.savez(out + "/store.npz", **{k: getattr(store, k) for k in
                                ("data", "label", "flow", "flow_ss2", "warp", "warp_ss2")})
test = synth.write_synthetic_test_set(out + "/test", n_scenes=1, h=32, w=32)
runner = TiledRunner(params.deterministic_fisrnet(device="cpu"), grid=(1, 1), boundary=32,
                     policy=F32, device="cpu")
ev = evaluate_test_set(runner, test["test_data_path"], test["test_label_path"],
                       test["test_flow_data_path"], test["test_warped_data_path"],
                       input_size=(32, 32), verbose=False)
res = main(["--phase", "train", "--device", "cpu", "--compute_dtype", "float32",
            "--train_data_path", corpus["data_path"], "--train_label_path", corpus["label_path"],
            "--train_flow_data_path", corpus["flow_path"],
            "--train_flow_ss2_data_path", corpus["flow_ss2_path"],
            "--train_warped_data_path", corpus["warp_path"],
            "--train_wapred_ss2_data_path", corpus["warp_ss2_path"],
            "--test_data_path", test["test_data_path"], "--test_label_path", test["test_label_path"],
            "--test_flow_data_path", test["test_flow_data_path"],
            "--test_warped_data_path", test["test_warped_data_path"],
            "--test_input_size", "32", "32", "--test_patch", "1", "1",
            "--checkpoint_dir", out + "/ckpt", "--log_dir", out + "/log",
            "--text_dir", out + "/text", "--test_img_dir", out + "/imgs",
            "--val_data_size", "2", "--batch_size", "2", "--epoch", "1"])
assert "h5py" not in {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
print(json.dumps({"corpus": corpus, "test": test,
                  "eval": [ev.n_frames, ev.psnr_vfi_sr, ev.ssim_sr],
                  "train": [res.n_frames, res.psnr_vfi_sr, res.ssim_sr]}))
"""


def test_corpus_and_test_set_path_runs_without_h5py(tmp_path):
    """write_synthetic_corpus -> TrainStore.from_files, write_synthetic_test_set
    -> evaluate_test_set and the CLI's --phase train (32x32 frames, f32, CPU)
    in a process where h5py cannot be imported; the store's arrays equal the
    JAX TrainStore.from_files' on the same files, exactly."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _NO_H5PY, str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    for what in ("eval", "train"):
        n, psnr, ssim = rec[what]
        assert n == 7 and np.isfinite(psnr) and np.isfinite(ssim), rec
    got = np.load(tmp_path / "store.npz")
    want = jdataset.TrainStore.from_files(**rec["corpus"], val_size=2)
    for k in got.files:
        assert got[k].dtype == getattr(want, k).dtype
        np.testing.assert_array_equal(got[k], getattr(want, k))
    np.testing.assert_array_equal(matio.read_warp_mat(rec["test"]["test_warped_data_path"]),
                                  jmatio.read_warp_mat(rec["test"]["test_warped_data_path"]))
