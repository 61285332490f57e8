"""Port: the host runtime (fisr_tpu_torch/native, csrc/native.cc) against its
plain versions (numpy, data/png_io, the crc loops of convert/tensor_bundle and
utils/tb_writer, ops/color) and against fisr_tpu.native, the JAX package's
library, built here with g++ and zlib.

Everything is exact: crc32c, the row gather and patches bit for bit; the
colour conversions on all 2^24 u8 triples, each constant set against its
numpy version and its JAX function; PNG decode pixel for pixel against PIL,
png_io and the JAX decoder, with png_io's exceptions and messages for
malformed input; PNG encode pixel for pixel through four decoders, with the
same bytes at every thread count.
"""

import ctypes
import io
import os
import struct
import sys
import threading
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from fisr_tpu.native import bindings as jnative
from fisr_tpu.ops import color as jcolor
from fisr_tpu_torch import native
from fisr_tpu_torch.convert import tensor_bundle
from fisr_tpu_torch.data import png_io
from fisr_tpu_torch.native import build
from fisr_tpu_torch.ops import color
from fisr_tpu_torch.utils import profiling, tb_writer

torch.set_num_threads(1)
PLAIN = native.plain_versions()


# ---- build ------------------------------------------------------------------

def test_build_names_the_library_by_source_and_rebuilds_an_edited_one(tmp_path):
    lib = build.build()
    assert lib.exists() and lib == build.target() and lib.parent == build.BUILD_DIR
    edited = tmp_path / "native.cc"
    edited.write_text(build.SOURCE.read_text() + f"\n// edited {os.getpid()} {tmp_path.name}\n")
    other = build.target(edited)
    assert other != lib and not other.exists()
    try:
        assert build.build(edited) == other and other.exists()
        assert build.BUILD_LOG["path"] == str(other) and build.BUILD_LOG["seconds"] > 0
        assert ctypes.CDLL(str(other)).fisr_crc32c  # the edited source's own library
    finally:
        other.unlink(missing_ok=True)
    broken = tmp_path / "broken.cc"
    broken.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cc"):
        build.build(broken)
    assert not build.target(broken).exists()
    assert native.available()


# ---- crc32c -----------------------------------------------------------------

def test_crc32c_rfc3720_check_value():
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"") == 0
    assert native.crc32c(bytes(32)) == 0x8A9136AA  # RFC 3720 B.4, 32 zero bytes


def test_crc32c_matches_plain_and_jax_at_every_length_to_1000():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    seeds = rng.integers(0, 2 ** 32, 1001, dtype=np.uint64)
    for n in range(1001):
        d, seed = data[:n], int(seeds[n])
        got = native.crc32c(d, seed)
        assert got == tensor_bundle._crc32c(d, seed) == jnative.crc32c(d, seed), n
        assert native.crc32c(d) == tb_writer.crc32c(d), n
    big = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()  # the plain lanes path
    assert native.crc32c(big, 7) == tensor_bundle._crc32c(big, 7) == jnative.crc32c(big, 7)
    assert native.crc32c(big[5000:], native.crc32c(big[:5000])) == native.crc32c(big)
    assert native.crc32c(bytearray(big)) == native.crc32c(memoryview(big)) == native.crc32c(big)


# ---- gather and patches -----------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int64])
def test_gather_rows_is_numpy_indexing(dtype):
    rng = np.random.default_rng(1)
    src = rng.normal(size=(37, 5, 4, 3)).astype(dtype) if dtype == np.float32 else \
        rng.integers(0, 200, (37, 5, 4, 3)).astype(dtype)
    idx = np.concatenate([rng.permutation(37), [0, 36, -1, -37, 5, 5]])
    got = native.gather_rows(src, idx)
    assert got.dtype == src.dtype and np.array_equal(got, PLAIN["gather_rows"](src, idx))
    two_d = idx[:12].reshape(3, 4)
    assert np.array_equal(native.gather_rows(src, two_d), src[two_d])
    if dtype == np.float32:
        assert np.array_equal(native.gather_rows(src, idx[:37]), jnative.gather_rows(src, idx[:37]))
    for bad in ([37], [-38]):
        with pytest.raises(IndexError) as want:
            src[np.asarray(bad)]
        with pytest.raises(IndexError, match=str(want.value)):
            native.gather_rows(src, bad)


@pytest.mark.parametrize("channels", [3, 29])
def test_extract_patches_is_numpy_slicing(channels):
    rng = np.random.default_rng(2)
    src = rng.normal(size=(70, 90, channels)).astype(np.float32)
    rects = [(0, 0), (38, 58), (10, 3), (38, 0), (0, 58), (17, 29)]
    got = native.extract_patches(src, rects, 32, 32)
    assert np.array_equal(got, PLAIN["extract_patches"](src, rects, 32, 32))
    assert np.array_equal(got, jnative.extract_patches(src, rects, 32, 32))
    for bad in ([(39, 0)], [(0, -1)]):
        with pytest.raises(ValueError, match="leaves the 70x90 frame"):
            native.extract_patches(src, bad, 32, 32)
    with pytest.raises(ValueError, match="need at least one array"):
        native.extract_patches(src, [], 32, 32)


# ---- colour: every u8 triple ------------------------------------------------

def _all_triples(part: int) -> np.ndarray:
    """Quarter `part` of the 2^24 u8 triples, in order."""
    a = np.arange(part << 22, (part + 1) << 22, dtype=np.uint32)
    return np.stack([(a >> 16) & 255, (a >> 8) & 255, a & 255], -1).astype(np.uint8)


COLOUR = {
    # binding: (its JAX function, the port's other function with these constants)
    "yuv2rgb_matlab_u8": (jnative.yuv2rgb_matlab_u8, None),
    "rgb2yuv_matlab_u8": (jnative.rgb2yuv_matlab_u8, None),
    "yuv2rgb_ops_u8": (lambda x: np.asarray(jcolor.yuv2rgb_matlab_u8(x)),
                       color.yuv2rgb_matlab_u8),
}


@pytest.mark.parametrize("name", sorted(COLOUR))
def test_colour_is_exact_on_all_2_24_triples(name):
    """Each binding against its plain version and its JAX function (the
    native library's constants, or the numpy route's), on every triple."""
    binding, (jax_fn, port_fn) = getattr(native, name), COLOUR[name]
    for part in range(4):
        tri = _all_triples(part)
        got = binding(tri)
        assert got.dtype == np.uint8 and got.shape == tri.shape
        assert np.array_equal(got, PLAIN[name](tri)), part
        assert np.array_equal(got, jax_fn(tri)), part
        if port_fn is not None:
            assert np.array_equal(got, port_fn(tri)), part
    sample = _all_triples(1)[::997][:7 * 11].reshape(-1, 7, 3)  # any leading shape
    assert np.array_equal(binding(sample), binding(sample.reshape(-1, 3)).reshape(sample.shape))


def test_the_two_constant_sets_differ_where_the_reference_paths_do():
    """The JAX package's native constants and ops/color's f32 ones give other
    truncations on a few triples: 87 for YUV -> RGB (why the test phase needs
    the native set), 233 for RGB -> YUV (the corpus builder's)."""
    n_yuv2rgb = n_rgb2yuv = 0
    for part in range(4):
        tri = _all_triples(part)
        n_yuv2rgb += int((native.yuv2rgb_matlab_u8(tri) != native.yuv2rgb_ops_u8(tri))
                         .any(-1).sum())
        n_rgb2yuv += int((native.rgb2yuv_matlab_u8(tri) != color.rgb2yuv_matlab_u8(tri))
                         .any(-1).sum())
    assert (n_yuv2rgb, n_rgb2yuv) == (87, 233)


# ---- PNG decode -------------------------------------------------------------

def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _png(ihdr: bytes, idat: bytes, *extra: bytes) -> bytes:
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + b"".join(extra)
            + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))


def _filtered(px: np.ndarray, ftypes) -> bytes:
    """Rows of px [h, w, bpp] u8 filtered with ftypes[y] (numpy), with their
    filter bytes."""
    h, w, c = px.shape
    cur = px.reshape(h, w * c).astype(np.int64)
    up = np.vstack([np.zeros((1, w * c), np.int64), cur[:-1]])
    left = np.hstack([np.zeros((h, c), np.int64), cur[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int64), up[:, :-c]])
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(cur), left, up, (left + up) // 2, paeth])
    ft = np.asarray(ftypes, np.uint8)
    pred = np.take_along_axis(preds, ft[None, :, None].astype(np.int64), 0)[0]
    return np.hstack([ft[:, None], ((cur - pred) % 256).astype(np.uint8)]).tobytes()


CTYPE_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("ctype", sorted(CTYPE_CHANNELS))
def test_decode_every_filter_type(tmp_path, ctype, ftype):
    rng = np.random.default_rng(3)
    h, w, c = 23, 31, CTYPE_CHANNELS[ctype]
    px = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    ftypes = [y % 5 for y in range(h)] if ftype == "mixed" else [ftype] * h
    data = _png(struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0),
                zlib.compress(_filtered(px, ftypes), 1))
    got = native.decode_png_bytes(data)
    want = np.repeat(px[..., :1], 3, 2) if c < 3 else px[..., :3]
    assert got.shape == (h, w, 3) and np.array_equal(got, want)
    assert np.array_equal(got, png_io.decode_png(data))
    path = tmp_path / "f.png"
    path.write_bytes(data)
    assert np.array_equal(native.decode_png(path), got)
    assert np.array_equal(jnative.decode_png(str(path)), got)
    assert np.array_equal(np.asarray(Image.open(path).convert("RGB")), got)


def _pil_png(mode: str, seed: int = 4) -> bytes:
    rng = np.random.default_rng(seed)
    if mode == "P":
        im = Image.fromarray(rng.integers(0, 256, (29, 41, 3), dtype=np.uint8), "RGB").quantize(37)
    else:
        bands = len(Image.new(mode, (1, 1)).getbands())
        arr = rng.integers(0, 256, (29, 41, bands), dtype=np.uint8)
        im = Image.fromarray(arr[..., 0] if bands == 1 else arr, mode)
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_decode_pil_written_files(tmp_path, mode):
    data = _pil_png(mode)
    path = tmp_path / f"{mode}.png"
    path.write_bytes(data)
    got = native.decode_png(path)
    assert np.array_equal(got, np.asarray(Image.open(path).convert("RGB")))
    assert np.array_equal(got, png_io.read_png(path))
    assert np.array_equal(got, native.decode_png_bytes(data))
    assert np.array_equal(got, jnative.decode_png(str(path)))


def _valid() -> bytes:
    px = np.random.default_rng(5).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    return png_io.encode_png(px)


def _ihdr(w=5, h=6, depth=8, ctype=2, interlace=0) -> bytes:
    return struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)


def _raw(h=6, w=5, bpp=3, ftype=0) -> bytes:
    return bytes([ftype] + [0] * (w * bpp)) * h


MALFORMED = {
    "empty": b"",
    "not_png": b"GIF89a" + bytes(40),
    "signature_only": b"\x89PNG\r\n\x1a\n",
    "cut_in_ihdr": _valid()[:20],
    "no_ihdr": b"\x89PNG\r\n\x1a\n" + _chunk(b"IDAT", zlib.compress(_raw())) + _chunk(b"IEND", b""),
    "ihdr_12_bytes": b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", _ihdr()[:12]),
    "plte_not_triples": _png(_ihdr(ctype=3), zlib.compress(_raw(bpp=1)), _chunk(b"PLTE", bytes(7))),
    "depth_16": _png(_ihdr(depth=16), zlib.compress(_raw(bpp=6))),
    "colour_type_5": _png(_ihdr(ctype=5), zlib.compress(_raw())),
    "interlaced": _png(_ihdr(interlace=1), zlib.compress(_raw())),
    "too_many_pixels": _png(_ihdr(w=20000, h=9000), b""),
    "bad_zlib_header": _png(_ihdr(), b"\x00\x01" + zlib.compress(_raw())[2:]),
    "bad_adler": _png(_ihdr(), zlib.compress(_raw())[:-1] + b"\x00"),
    "truncated_data": _png(_ihdr(), zlib.compress(_raw())[:-9]),
    "no_idat": b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", _ihdr()) + _chunk(b"IEND", b""),
    "too_much_data": _png(_ihdr(), zlib.compress(_raw() + bytes(7))),
    "filter_type_7": _png(_ihdr(), zlib.compress(_raw()[:16] + _raw(ftype=7)[16:32]
                                                 + _raw()[32:])),
    "palette_without_plte": _png(_ihdr(ctype=3), zlib.compress(_raw(bpp=1))),
}

# what png_io accepts though a strict reader would not: the same pixels
LENIENT = {
    "cut_after_idat": _valid()[:-20],  # no adler32, no IEND
    "ihdr_after_text": (b"\x89PNG\r\n\x1a\n" + _chunk(b"tEXt", b"k\0v") + _chunk(b"IHDR", _ihdr())
                        + _chunk(b"IDAT", zlib.compress(_raw())) + _chunk(b"IEND", b"")),
    "two_ihdr": (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", _ihdr(w=9, h=2))
                 + _chunk(b"IHDR", _ihdr()) + _chunk(b"IDAT", zlib.compress(_raw()))),
    "idat_in_pieces": (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", _ihdr())
                       + b"".join(_chunk(b"IDAT", bytes([b])) for b in zlib.compress(_raw(ftype=4)))
                       + _chunk(b"IEND", b"")),
    "long_palette": _png(_ihdr(ctype=3), zlib.compress(bytes([0, 1, 255, 4, 7, 200]) * 6),
                         _chunk(b"PLTE", bytes(range(256)) * 3 + bytes(30))),
    "data_after_stream": _png(_ihdr(), zlib.compress(_raw()) + b"junk"),
    "zero_width": _png(_ihdr(w=0), zlib.compress(bytes(6))),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_png_raises_what_png_io_raises(tmp_path, case):
    data = MALFORMED[case]
    with pytest.raises(Exception) as plain:
        png_io.decode_png(data)
    with pytest.raises(type(plain.value)) as got:
        native.decode_png_bytes(data)
    assert type(got.value) is type(plain.value) and str(got.value) == str(plain.value)
    path = tmp_path / f"{case}.png"
    path.write_bytes(data)
    with pytest.raises(Exception) as plain_file:
        png_io.read_png(path)
    with pytest.raises(type(plain_file.value)) as got_file:
        native.decode_png(path)
    assert str(got_file.value) == str(plain_file.value)
    with pytest.raises(type(plain_file.value)) as got_batch:  # as np.stack of read_png
        native.decode_png_batch([path])
    assert str(got_batch.value) == str(plain_file.value)


@pytest.mark.parametrize("case", sorted(LENIENT))
def test_lenient_png_decodes_as_png_io(case):
    data = LENIENT[case]
    want = png_io.decode_png(data)
    got = native.decode_png_bytes(data)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_decode_png_batch_is_stacked_read_png(tmp_path):
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (7, 19, 26, 3), dtype=np.uint8)
    paths = []
    for i, fr in enumerate(frames):
        paths.append(str(tmp_path / f"f{i}.png"))
        png_io.write_png(fr, paths[-1])
    Image.fromarray(frames[3]).save(paths[3])  # PIL's adaptive filters in the middle
    got = native.decode_png_batch(paths)
    assert np.array_equal(got, frames)
    assert np.array_equal(got, PLAIN["decode_png_batch"](paths))
    assert np.array_equal(got, jnative.decode_png_batch(paths, 19, 26))
    png_io.write_png(frames[0][:, :20], tmp_path / "narrow.png")
    with pytest.raises(ValueError, match="all input arrays must have the same shape"):
        native.decode_png_batch(paths + [str(tmp_path / "narrow.png")])
    with pytest.raises(ValueError, match="all input arrays must have the same shape"):
        native.decode_png_batch([str(tmp_path / "narrow.png")] + paths)
    (tmp_path / "bad.png").write_bytes(b"nope")
    with pytest.raises(ValueError, match="bad.png: not a PNG file"):  # before the size check
        native.decode_png_batch([str(tmp_path / "narrow.png")] + paths + [str(tmp_path / "bad.png")])
    with pytest.raises(FileNotFoundError):
        native.decode_png_batch(paths + [str(tmp_path / "missing.png")])
    with pytest.raises(ValueError, match="need at least one array"):
        native.decode_png_batch([])


# ---- PNG encode -------------------------------------------------------------

def _scene_4k() -> np.ndarray:
    """A 2112x3840 output-sized frame: the benchmark's scene at 1056x1920,
    upscaled 2x (bicubic)."""
    from fisrbench.harness import scene

    g = torch.Generator().manual_seed(3240000011)
    yuv = scene.clip(g, 1, 1056, 1920, 6.0, 8, (60, 200), (4.0, 16.0), "cpu")[0]
    up = torch.nn.functional.interpolate(yuv.permute(2, 0, 1)[None].float(), scale_factor=2,
                                         mode="bicubic", align_corners=False)
    return up[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def _ramp(h, w, seed=7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 24, (h, w, 3)) + np.arange(w)[None, :, None] // 5).astype(np.uint8)


ENCODE_CASES = {
    "1x1": lambda: _ramp(1, 1),
    "6x5": lambda: _ramp(6, 5),
    "333x517": lambda: _ramp(333, 517),
    "640x900": lambda: _ramp(640, 900),
    "scene_2112x3840": _scene_4k,
    "constant": lambda: np.full((100, 257, 3), (17, 200, 3), np.uint8),  # runs alone
    "noise": lambda: np.random.default_rng(8).integers(0, 256, (70, 300, 3), dtype=np.uint8),
    "width_1": lambda: _ramp(77, 1),
    "height_1": lambda: _ramp(1, 1000),
    "strip_boundary": lambda: _ramp(64, 45),  # two strips of 32 rows, the second full
}


def _idat_rows(data: bytes, h: int, w: int) -> np.ndarray:
    """The inflated IDAT stream of a PNG (zlib.decompress checks its adler32)
    as [h, 1 + 3 w] rows."""
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_is_pixel_exact_on_one_and_several_threads(tmp_path, case):
    from fisrbench.reference import png as ref_png

    img = ENCODE_CASES[case]()
    h, w, _ = img.shape
    data = native.encode_png_bytes(img, threads=1)
    for threads in (2, 3, 8, None, 1):  # the same bytes at every thread count, and again
        assert native.encode_png_bytes(img, threads=threads) == data, threads
    native.encode_png(img, tmp_path / "x.png")
    assert (tmp_path / "x.png").read_bytes() == data
    assert np.array_equal(png_io.decode_png(data), img)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img)
    assert np.array_equal(native.decode_png_bytes(data), img)
    assert np.array_equal(ref_png.decode(data), img)
    assert set(np.unique(_idat_rows(data, h, w)[:, 0])) <= {0, 1, 2}
    if case == "noise":  # no coded strip is smaller than its rows
        assert len(data) > h * (1 + 3 * w)


def test_encode_from_more_threads_than_cores_gives_each_caller_its_bytes():
    """Callers on 16 threads at once share the runtime's kept pool (one run
    at a time, its threads capped per call): every call returns its frame's
    bytes, and no call hangs."""
    frames = [_ramp(96 + 32 * (k % 3), 200 + 7 * k, seed=k) for k in range(16)]
    want = [native.encode_png_bytes(f, threads=1) for f in frames]
    got, errors = [None] * 16, []

    def call(k):
        try:
            for _ in range(3):
                got[k] = native.encode_png_bytes(frames[k], threads=(None, 2, 3, 8)[k % 4])
                assert got[k] == want[k]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=call, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors and got == want


def test_encode_counts_frames_bytes_and_stored_strips(tmp_path):
    def png_counters():
        c = profiling.totals()["counters"]
        return {k: c.get(f"png.{k}", 0) for k in ("frames", "raw_bytes", "bytes", "stored_strips")}

    smooth, noise = ENCODE_CASES["640x900"](), ENCODE_CASES["noise"]()
    before = png_counters()
    data = native.encode_png_bytes(smooth)
    native.encode_png(noise, tmp_path / "noise.png")
    after = png_counters()
    size = (tmp_path / "noise.png").stat().st_size
    assert after["frames"] - before["frames"] == 2
    assert after["raw_bytes"] - before["raw_bytes"] == 640 * (1 + 3 * 900) + 70 * (1 + 3 * 300)
    assert after["bytes"] - before["bytes"] == len(data) + size
    assert after["stored_strips"] - before["stored_strips"] == 3  # the noise's 3 strips, stored
    before = after
    native.encode_png_bytes(smooth, threads=2)
    after = png_counters()
    assert after["bytes"] - before["bytes"] == len(data)
    assert after["stored_strips"] == before["stored_strips"]  # its strips are all coded


def test_benchmark_reads_the_png_bytes_counter_as_mb_a_frame(monkeypatch):
    from fisrbench.harness.manifest import Manifest

    read = Manifest().reader("png_mb_per_frame.video")
    counters = {"video.frames": 30, "png.bytes": 450_000_000}
    monkeypatch.setattr(profiling, "totals", lambda: {"spans": {}, "counters": counters})
    assert read({}) == pytest.approx(15.0, rel=1e-12)  # 450e6 bytes / 30 frames
    del counters["png.bytes"]  # a program that does not count the bytes
    assert read({}) is None
    counters.update({"video.frames": 0, "png.bytes": 5})
    assert read({}) is None
    monkeypatch.delattr(profiling, "totals")  # a program with no recorder
    assert read({}) is None


def test_encode_raises_what_png_io_raises(tmp_path):
    with pytest.raises(ValueError, match=r"\[H, W, 3\] uint8, got shape \(4, 4\)"):
        native.encode_png_bytes(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match=r"got shape \(4, 4, 4\)"):
        native.encode_png(np.zeros((4, 4, 4), np.uint8), tmp_path / "x.png")
    with pytest.raises(FileNotFoundError) as plain:
        png_io.write_png(np.zeros((4, 4, 3), np.uint8), tmp_path / "no" / "x.png")
    with pytest.raises(FileNotFoundError) as got:
        native.encode_png(np.zeros((4, 4, 3), np.uint8), tmp_path / "no" / "x.png")
    assert str(got.value) == str(plain.value)
    floats = np.full((3, 2, 3), 7.9)  # cast as np.asarray(..., np.uint8) does
    assert np.array_equal(native.decode_png_bytes(native.encode_png_bytes(floats, threads=1)),
                          png_io.decode_png(png_io.encode_png(floats)))
