"""ctypes bindings of the port's host runtime (csrc/native.cc), each beside
its plain version.

The names are the JAX package's (fisr_tpu/native): `decode_png`,
`decode_png_batch`, `encode_png` (to a path), `gather_rows`,
`yuv2rgb_matlab_u8`, `rgb2yuv_matlab_u8`, `extract_patches`, `crc32c`,
`available`; `decode_png_bytes` and `encode_png_bytes` are the server's
buffer variants, `yuv2rgb_ops_u8` is the colour conversion with the
constants of ops/color, and `zstd_decompress`, `zstd_decompress_batch` and
`zstd_decompress_bounded` decode zstd frames (csrc/zstd.cc; the orbax
checkpoints' nodes and chunks), and `flow_sample` assembles one flow
training sample (crop, data/augment's plan, / 255) into a batch's slots.

Two sets of colour constants:
* `yuv2rgb_matlab_u8` / `rgb2yuv_matlab_u8` use the JAX package's native
  constants (MATLAB's matrix times 255 in double, the offset folded in):
  the bits of fisr_tpu.native, which the JAX test phase and corpus builder
  use;
* `yuv2rgb_ops_u8` uses ops/color's f32 constants widened to double: the
  bits of ops/color.yuv2rgb_matlab_u8, which the JAX video pipeline uses.

Each function checks shapes, bounds and dtypes here before it passes a
pointer, raises what its plain version raises for bad input, and never falls
back to the plain version: a failed build raises. ctypes releases the GIL for
every call. `plain_versions()` maps each name to its plain version (numpy,
the stdlib codec of data/png_io, the crc loop of convert/tensor_bundle,
data/augment.apply_plan); the
tests and chip_smoke.py hold every binding against it. The zstd decoder has
none (see `plain_versions`).
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional, Sequence

import numpy as np

from fisr_tpu_torch.data.augment import apply_plan, scaled_size
from fisr_tpu_torch.native import build
from fisr_tpu_torch.utils import profiling

__all__ = ["available", "decode_png", "decode_png_bytes", "decode_png_batch", "encode_png",
           "encode_png_bytes", "gather_rows", "extract_patches", "yuv2rgb_matlab_u8",
           "rgb2yuv_matlab_u8", "yuv2rgb_ops_u8", "crc32c", "zstd_decompress",
           "zstd_decompress_batch", "zstd_decompress_bounded", "flow_sample", "zlib_version",
           "plain_versions"]

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64, _int = ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "fisr_zlib_version": ([], ctypes.c_char_p),
    "fisr_crc32c": ([ctypes.c_void_p, _i64, ctypes.c_uint32], ctypes.c_uint32),
    "fisr_gather_rows": ([ctypes.c_void_p, _i64, _i64p, _i64, ctypes.c_void_p], None),
    "fisr_extract_patches": ([ctypes.c_void_p, _i64, _i64, _i64p, _i64p, _i64, _i64, _i64,
                              ctypes.c_void_p], None),
    "fisr_color_u8": ([_u8p, _u8p, _i64, _f64p, _f64p], None),
    "fisr_png_decode": ([ctypes.c_void_p, _i64, _u8p, _i64, _i64p, ctypes.c_char_p], _int),
    "fisr_png_decode_batch": ([ctypes.c_char_p, _i64, _i64, _u8p, _i64, _i64, _i32p, _i64p,
                               ctypes.c_char_p], _i64),
    "fisr_png_bound": ([_i64, _i64], _i64),
    "fisr_png_encode": ([_u8p, _i64, _i64, _int, _u8p, _i64, _i64p], _i64),
    "fisr_png_write": ([ctypes.c_char_p, _u8p, _i64, _i64, _i64p], _int),
    "fisr_zstd_decompress_batch": ([ctypes.c_void_p, _i64p, ctypes.c_void_p, _i64p, _i64, _int,
                                    _i64p, _i32p, ctypes.c_char_p], _i64),
    "fisr_flow_sample": ([_u8p, ctypes.c_void_p, _i64, _i64, _i64, _i64, _i64, _i64, _int, _int,
                          _i64, _i64, _int, ctypes.c_double, _i64, _i64, ctypes.c_void_p,
                          ctypes.c_void_p], _int),
}
_INFO, _MSG = 8, 256  # int64s of a decode's info, bytes of its message
_MAX_PIXELS = 178_956_970  # data/png_io._MAX_PIXELS


def _lib() -> ctypes.CDLL:
    lib = build.load()
    if not getattr(lib, "_fisr_typed", False):
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        lib._fisr_typed = True
    return lib


def available() -> bool:
    """True when the library builds and loads here (a failed build raises in
    every other function)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def zlib_version() -> str:
    """The version of the zlib the library linked, as zlibVersion() says."""
    return _lib().fisr_zlib_version().decode()


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


# ---- crc32c -----------------------------------------------------------------

def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of the bytes-like `data`, continuing `crc`."""
    buf = np.frombuffer(data, np.uint8)
    return int(_lib().fisr_crc32c(buf.ctypes.data, buf.size, crc & 0xFFFFFFFF))


# ---- zstd -------------------------------------------------------------------

def _zstd(frames: Sequence, caps, threads: int) -> tuple:
    """Decode each buffer into at most caps[i] bytes: (arrays of cap bytes,
    the bytes each decoded to); the first buffer that fails raises."""
    caps = np.asarray(caps, np.int64).reshape(-1)
    if len(frames) != caps.size:
        raise ValueError(f"{len(frames)} frames but {caps.size} sizes")
    if (caps < 0).any():
        raise ValueError(f"negative size {int(caps[caps < 0][0])}")
    srcs = [np.frombuffer(f, np.uint8) for f in frames]
    outs = [np.empty(int(k), np.uint8) for k in caps]
    n = len(srcs)
    src_ptrs = np.array([a.ctypes.data for a in srcs], np.uint64)
    dst_ptrs = np.array([a.ctypes.data for a in outs], np.uint64)
    lens = np.array([a.size for a in srcs], np.int64)
    sizes = np.zeros(n, np.int64)
    codes = np.zeros(n, np.int32)
    msgs = ctypes.create_string_buffer(n * _MSG)
    if _lib().fisr_zstd_decompress_batch(src_ptrs.ctypes.data, lens.ctypes.data_as(_i64p),
                                         dst_ptrs.ctypes.data, caps.ctypes.data_as(_i64p), n,
                                         threads, sizes.ctypes.data_as(_i64p),
                                         codes.ctypes.data_as(_i32p), msgs):
        i = int(np.flatnonzero(codes)[0])
        text = msgs.raw[i * _MSG:(i + 1) * _MSG].split(b"\0", 1)[0].decode(errors="replace")
        raise ValueError(f"zstd: {text}" if n == 1 else f"zstd buffer {i}: {text}")
    return outs, sizes


def zstd_decompress(frame, out_size: int) -> np.ndarray:
    """The zstd frames in the bytes-like `frame` (RFC 8878, back to back;
    skippable frames skipped; no dictionaries) decoded into a uint8 array
    that must come out exactly `out_size` bytes long. A malformed frame, a
    content checksum or size that does not match, or another decoded size
    raises ValueError."""
    return zstd_decompress_batch([frame], [out_size], threads=1)[0]


def zstd_decompress_batch(frames: Sequence, out_sizes: Sequence[int],
                          threads: Optional[int] = None) -> list:
    """[zstd_decompress(f, n) for f, n in zip(frames, out_sizes)], decoded on
    `threads` threads (default: the host's cores); the first buffer that
    fails raises its ValueError."""
    outs, sizes = _zstd(frames, out_sizes, threads or 0)
    for i, (out, size) in enumerate(zip(outs, sizes)):
        if size != out.size:
            where = "" if len(outs) == 1 else f" buffer {i}:"
            raise ValueError(f"zstd:{where} the frames decode to {size} bytes, not {out.size}")
    return outs


def zstd_decompress_bounded(frame, max_size: int) -> np.ndarray:
    """zstd_decompress for a buffer of unknown decoded size (frames without a
    content size): its bytes, at most `max_size`, else ValueError."""
    outs, sizes = _zstd([frame], [max_size], 1)
    return outs[0][:sizes[0]]


# ---- gather and patches -----------------------------------------------------

def gather_rows(src: np.ndarray, idx) -> np.ndarray:
    """src[idx] for integer indices along axis 0 (negative ones count from the
    end, as numpy's); rows copied on threads."""
    src = np.ascontiguousarray(src)
    idx = np.asarray(idx)
    if src.ndim == 0 or not np.issubdtype(idx.dtype, np.integer):
        raise IndexError("gather_rows takes integer indices into axis 0 of an array")
    n = src.shape[0]
    flat = idx.astype(np.int64).reshape(-1)
    bad = flat[(flat < -n) | (flat >= n)]
    if bad.size:
        raise IndexError(f"index {int(bad[0])} is out of bounds for axis 0 with size {n}")
    flat = np.where(flat < 0, flat + n, flat)
    out = np.empty(idx.shape + src.shape[1:], src.dtype)
    row_bytes = src.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    _lib().fisr_gather_rows(src.ctypes.data, row_bytes, flat.ctypes.data_as(_i64p), flat.size,
                            out.ctypes.data)
    return out


def extract_patches(src: np.ndarray, rects: Sequence[tuple], ph: int, pw: int) -> np.ndarray:
    """src [H, W, ...]; rects [(y0, x0), ...] -> [n, ph, pw, ...], each patch
    inside the frame."""
    src = np.ascontiguousarray(src)
    if not len(rects):
        raise ValueError("need at least one array to stack")
    y0s = np.asarray([r[0] for r in rects], np.int64)
    x0s = np.asarray([r[1] for r in rects], np.int64)
    hh, ww = src.shape[:2]
    if ph < 0 or pw < 0 or (y0s < 0).any() or (x0s < 0).any() or \
            (y0s + ph > hh).any() or (x0s + pw > ww).any():
        raise ValueError(f"a {ph}x{pw} patch at {list(zip(y0s.tolist(), x0s.tolist()))} "
                         f"leaves the {hh}x{ww} frame")
    out = np.empty((len(rects), ph, pw) + src.shape[2:], src.dtype)
    px_bytes = src.itemsize * int(np.prod(src.shape[2:], dtype=np.int64))
    _lib().fisr_extract_patches(src.ctypes.data, ww, px_bytes, y0s.ctypes.data_as(_i64p),
                                x0s.ctypes.data_as(_i64p), len(rects), ph, pw,
                                out.ctypes.data)
    return out


# ---- flow training sample ---------------------------------------------------

def _out_slot(a: np.ndarray, shape: tuple, name: str) -> None:
    if not (isinstance(a, np.ndarray) and a.dtype == np.float32 and a.shape == shape
            and a.flags.c_contiguous and a.flags.writeable):
        raise ValueError(f"{name} must be a writeable C-contiguous float32 array of shape "
                         f"{shape}, got {getattr(a, 'dtype', type(a))} {getattr(a, 'shape', '')}")


def flow_sample(pair: np.ndarray, flow: np.ndarray, corner: tuple, crop_hw: tuple, plan,
                x_out: np.ndarray, y_out: np.ndarray) -> None:
    """One flow training sample written into x_out [2, ch, cw, 3] and y_out
    [ch, cw, 2] (float32, C-contiguous: a batch's slots): the crop_hw crop at
    `corner` (y0, x0) of the u8 pair [2, H, W, 3] and its f32 flow [H, W, 2],
    augmented as data/augment.apply_plan does with `plan` (an AugmentPlan, or
    None), the frames / 255; its bits, rows on the host's cores."""
    pair = np.ascontiguousarray(pair)
    flow = np.ascontiguousarray(flow)
    if pair.dtype != np.uint8 or pair.ndim != 4 or pair.shape[0] != 2 or pair.shape[3] != 3:
        raise ValueError(f"a pair is u8 [2, H, W, 3], got {pair.dtype} {pair.shape}")
    hh, ww = pair.shape[1:3]
    if flow.dtype != np.float32 or flow.shape != (hh, ww, 2):
        raise ValueError(f"the flow of a {hh}x{ww} pair is f32 [{hh}, {ww}, 2], "
                         f"got {flow.dtype} {flow.shape}")
    (y0, x0), (ch, cw) = (int(v) for v in corner), (int(v) for v in crop_hw)
    if ch < 1 or cw < 1 or y0 < 0 or x0 < 0 or y0 + ch > hh or x0 + cw > ww:
        raise ValueError(f"a {ch}x{cw} crop at ({y0}, {x0}) leaves the {hh}x{ww} pair")
    _out_slot(x_out, (2, ch, cw, 3), "x_out")
    _out_slot(y_out, (ch, cw, 2), "y_out")
    lr, ud, (tx, ty), ratio = False, False, (0, 0), None
    if plan is not None:
        lr, ud, (tx, ty), ratio = plan.fliplr, plan.flipud, plan.shift, plan.ratio
    sh, sw = (ch, cw) if ratio is None else scaled_size(ch, cw, ratio)
    if sh < 1 or sw < 1:  # _resize_bilinear's h / out_h
        raise ZeroDivisionError(f"ratio {ratio} resizes the {ch}x{cw} crop to {sh}x{sw}")
    if _lib().fisr_flow_sample(_ptr(pair), flow.ctypes.data, hh, ww, y0, x0, ch, cw, int(lr),
                               int(ud), int(tx), int(ty), int(ratio is not None),
                               1.0 if ratio is None else float(ratio), sh, sw,
                               x_out.ctypes.data, y_out.ctypes.data):
        raise MemoryError("no memory or threads to assemble the flow sample")


def _plain_flow_sample(pair, flow, corner, crop_hw, plan, x_out, y_out) -> None:
    """numpy version of flow_sample: FlowDataset's crop, then apply_plan."""
    (y0, x0), (ch, cw) = corner, crop_hw
    x = np.asarray(pair).astype(np.float32)[:, y0:y0 + ch, x0:x0 + cw]
    y = np.asarray(flow)[y0:y0 + ch, x0:x0 + cw]
    if plan is not None:
        x, y = apply_plan(x, y, plan)
    x_out[...] = x / 255.0
    y_out[...] = y


# ---- colour -----------------------------------------------------------------

# The JAX package's native constants (fisr_tpu/native/loader.cc): MATLAB's
# ycbcr2rgb matrix times 255 and the rgb2ycbcr matrix over 255, in double;
# the YUV -> RGB offset is the matrix times (16, 128, 128), summed in order.
_TINV = ((0.00456621, 0.0, 0.00625893),
         (0.00456621, -0.00153632, -0.00318811),
         (0.00456621, 0.00791071, 0.0))
_T_FWD = ((65.481, 128.553, 24.966),
          (-37.797, -74.203, 112.0),
          (112.0, -93.786, -18.214))
_OFFSET = (16.0, 128.0, 128.0)
_M_YUV2RGB_NATIVE = np.array([[c * 255 for c in r] for r in _TINV], np.float64)
_B_YUV2RGB_NATIVE = -np.array([r[0] * _OFFSET[0] + r[1] * _OFFSET[1] + r[2] * _OFFSET[2]
                               for r in _M_YUV2RGB_NATIVE.tolist()], np.float64)
_M_RGB2YUV_NATIVE = np.array([[c / 255 for c in r] for r in _T_FWD], np.float64)
_B_RGB2YUV_NATIVE = np.array(_OFFSET, np.float64)


def _ops_constants():
    from fisr_tpu_torch.ops import color

    return (color._M_YUV2RGB.astype(np.float64),
            -color._B_YUV2RGB.astype(np.float64))


def _color(x: np.ndarray, m: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.uint8)
    if x.ndim == 0 or x.shape[-1] != 3:
        raise ValueError(f"colour conversion takes [..., 3] arrays, got shape {x.shape}")
    out = np.empty_like(x)
    m = np.ascontiguousarray(m, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    _lib().fisr_color_u8(_ptr(x), _ptr(out), x.size // 3, m.ctypes.data_as(_f64p),
                         b.ctypes.data_as(_f64p))
    return out


def yuv2rgb_matlab_u8(yuv: np.ndarray) -> np.ndarray:
    """u8 YUV -> u8 RGB with the JAX package's native constants (its test
    phase's saved frames): double sums, clip, truncation."""
    return _color(yuv, _M_YUV2RGB_NATIVE, _B_YUV2RGB_NATIVE)


def rgb2yuv_matlab_u8(rgb: np.ndarray) -> np.ndarray:
    """u8 RGB -> u8 YUV with the JAX package's native constants (its corpus
    builder's conversion): double sums, clip, truncation."""
    return _color(rgb, _M_RGB2YUV_NATIVE, _B_RGB2YUV_NATIVE)


def yuv2rgb_ops_u8(yuv: np.ndarray) -> np.ndarray:
    """u8 YUV -> u8 RGB with ops/color's constants: the bits of
    ops.color.yuv2rgb_matlab_u8 (the video pipeline's and the server's)."""
    return _color(yuv, *_ops_constants())


def _plain_color(x: np.ndarray, m: np.ndarray, b: np.ndarray) -> np.ndarray:
    """numpy version of fisr_color_u8: double, summed in the library's order."""
    x = np.asarray(x, np.uint8).astype(np.float64)
    out = [x[..., 0] * m[r, 0] + x[..., 1] * m[r, 1] + x[..., 2] * m[r, 2] + b[r]
           for r in range(3)]
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


# ---- PNG --------------------------------------------------------------------

def _decode_error(code: int, info: np.ndarray, msg: bytes, path=None) -> Exception:
    """The exception data/png_io.read_png (path) or decode_png raises."""
    w, h, depth, ctype, interlace, got, want, extra = (int(v) for v in info)
    if code == 14:
        return OSError(extra, os.strerror(extra), path)
    if code == 13:
        return MemoryError("no memory to decode the PNG")
    if code == 2:
        return struct.error("unpack requires a buffer of 13 bytes")
    text = {
        1: "not a PNG file",
        3: f"cannot reshape array of size {extra} into shape (3)",
        4: "PNG has no IHDR chunk",
        5: "only 8-bit non-interlaced greyscale, RGB, RGBA or palette PNGs are supported "
           f"(depth {depth}, colour type {ctype}, interlace {interlace})",
        6: f"PNG of {w}x{h} pixels exceeds the {_MAX_PIXELS}-pixel limit",
        7: "corrupt PNG image data: " + msg.split(b"\0", 1)[0].decode(errors="replace"),
        8: f"PNG image data holds {'more than ' if got > want else ''}{min(got, want)} bytes, "
           f"its {w}x{h} header says {want}",
        9: f"bad PNG filter type {extra}",
        10: "palette PNG has no PLTE chunk",
        12: "all input arrays must have the same shape",
    }.get(code, f"PNG decode failed with status {code}")
    return ValueError(f"{path}: {text}" if path is not None and code != 12 else text)


def _header_size(buf: np.ndarray):
    """(h, w) of a PNG whose first chunk is its IHDR, else (0, 0)."""
    if buf.size >= 24 and buf[12:16].tobytes() == b"IHDR":
        w, h = struct.unpack(">II", buf[16:24].tobytes())
        if w * h <= _MAX_PIXELS:
            return h, w
    return 0, 0


def decode_png_bytes(data) -> np.ndarray:
    """The bytes of a PNG file as u8 [H, W, 3] RGB: data/png_io.decode_png's
    formats, results and errors."""
    return _decode(data, None)


def _decode(data, path) -> np.ndarray:
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(_INFO, np.int64)
    msg = ctypes.create_string_buffer(_MSG)
    h, w = _header_size(buf)
    for _ in range(2):  # again at the size the decoder found, when it was not the first chunk's
        out = np.empty((h, w, 3), np.uint8)
        code = lib.fisr_png_decode(buf.ctypes.data, buf.size, _ptr(out), out.size,
                                   info.ctypes.data_as(_i64p), msg)
        if code != 11:
            break
        w, h = int(info[0]), int(info[1])
    if code:
        raise _decode_error(code, info, msg.raw, path)
    return out.reshape(int(info[1]), int(info[0]), 3)


def decode_png(path) -> np.ndarray:
    """Read a PNG file as u8 [H, W, 3] RGB (data/png_io.read_png)."""
    with open(path, "rb") as f:
        data = f.read()
    return _decode(data, path)


def decode_png_batch(paths: Sequence) -> np.ndarray:
    """PNG files of one size as u8 [n, h, w, 3], decoded on threads: what
    np.stack of their read_png gives, and the error the first bad file gives
    (h, w are the first file's)."""
    if not len(paths):
        raise ValueError("need at least one array to stack")
    with open(paths[0], "rb") as f:
        head = np.frombuffer(f.read(33), np.uint8)
    h, w = _header_size(head)
    if (h, w) == (0, 0):  # its IHDR is not its first chunk, or it does not decode
        h, w = decode_png(paths[0]).shape[:2]
    enc = [os.fsencode(p) for p in paths]
    stride = max(len(p) for p in enc) + 1
    names = b"".join(p.ljust(stride, b"\0") for p in enc)
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    codes = np.zeros(n, np.int32)
    info = np.zeros((n, _INFO), np.int64)
    msgs = ctypes.create_string_buffer(n * _MSG)
    failed = _lib().fisr_png_decode_batch(names, stride, n, _ptr(out), h, w,
                                          codes.ctypes.data_as(_i32p),
                                          info.ctypes.data_as(_i64p), msgs)
    if failed:
        for i in range(n):  # the first file that does not decode, then a size mismatch
            if codes[i] not in (0, 12):
                raise _decode_error(int(codes[i]), info[i], msgs.raw[i * _MSG:(i + 1) * _MSG],
                                    paths[i])
        raise _decode_error(12, info[0], b"")
    return out


def _frame(img: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(img, np.uint8)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"a PNG frame is [H, W, 3] uint8, got shape {a.shape}")
    return a


def _count_png(h: int, w: int, size: int, stored: int) -> None:
    profiling.count("png.frames")
    profiling.count("png.raw_bytes", h * (1 + 3 * w))
    profiling.count("png.bytes", size)
    profiling.count("png.stored_strips", stored)


def encode_png_bytes(img: np.ndarray, threads: Optional[int] = None) -> bytes:
    """u8 [H, W, 3] as the bytes of an 8-bit RGB PNG, deflated by the
    runtime's own coder in strips of 32 rows (unfiltered or Up-filtered) on up
    to `threads` threads of its kept pool (default: the host's cores). The
    same bytes at every thread count; png_io.encode_png's pixels. Counts
    `png.*` (frames, raw and PNG bytes, strips stored)."""
    a = _frame(img)
    h, w, _ = a.shape
    lib = _lib()
    out = np.empty(lib.fisr_png_bound(h, w), np.uint8)
    stored = ctypes.c_int64(0)
    n = lib.fisr_png_encode(_ptr(a), h, w, threads or 0, _ptr(out), out.size,
                            ctypes.byref(stored))
    if n < 0:
        raise MemoryError("no memory to encode the PNG frame")
    _count_png(h, w, n, stored.value)
    return out[:n].tobytes()


def encode_png(img: np.ndarray, path) -> None:
    """Write u8 [H, W, 3] to `path` as an 8-bit RGB PNG (data/png_io.write_png's
    pixels, encode_png_bytes' bytes)."""
    a = _frame(img)
    stored = ctypes.c_int64(0)
    rc = _lib().fisr_png_write(os.fsencode(path), _ptr(a), a.shape[0], a.shape[1],
                               ctypes.byref(stored))
    if rc == -2:
        raise MemoryError("no memory to encode the PNG frame")
    if rc:
        raise OSError(rc, os.strerror(rc), str(path))
    _count_png(a.shape[0], a.shape[1], os.path.getsize(path), stored.value)


# ---- plain versions ---------------------------------------------------------

def plain_versions() -> dict:
    """{binding name: its plain version}, each called as the binding is.

    `zstd_decompress` has none: a second full decoder in Python would be
    code that no path runs. The tests hold it bit-equal to the `zstandard`
    package (imported there only) on a matrix of frames and on every chunk
    of checkpoint_dir/pwcnet, and chip_smoke.py holds the orbax read it
    serves against a SHA-256 of the tree pinned by those tests."""
    from fisr_tpu_torch.convert.tensor_bundle import _crc32c
    from fisr_tpu_torch.data import png_io
    from fisr_tpu_torch.ops import color

    return {
        "crc32c": _crc32c,
        "gather_rows": lambda src, idx: np.asarray(src)[idx],
        "extract_patches": lambda src, rects, ph, pw: np.stack(
            [np.asarray(src)[y:y + ph, x:x + pw] for y, x in rects]),
        "yuv2rgb_matlab_u8": lambda yuv: _plain_color(yuv, _M_YUV2RGB_NATIVE,
                                                      _B_YUV2RGB_NATIVE),
        "rgb2yuv_matlab_u8": lambda rgb: _plain_color(rgb, _M_RGB2YUV_NATIVE,
                                                      _B_RGB2YUV_NATIVE),
        "yuv2rgb_ops_u8": color.yuv2rgb_matlab_u8,
        "decode_png": png_io.read_png,
        "decode_png_bytes": png_io.decode_png,
        "decode_png_batch": lambda paths: np.stack([png_io.read_png(p) for p in paths]),
        "encode_png": png_io.write_png,
        "encode_png_bytes": png_io.encode_png,
        "flow_sample": _plain_flow_sample,
    }
