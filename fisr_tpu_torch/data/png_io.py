"""PNG frame I/O with the standard library (zlib + struct) and numpy.

The FISR datasets keep YUV frames in ordinary 3-channel PNGs (the channels
are Y, U, V) and the video phase writes its predictions both as RGB and as
raw YUV PNGs. This codec covers what those files use: 8-bit RGB, not
interlaced, every filter type on read. It writes filter 0
(none) rows, zlib level 1: the 4K outputs are large and encoding time, not
file size, is what the video phase waits on.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib

import numpy as np

__all__ = ["read_png", "write_png", "encode_png", "list_pngs"]

_SIG = b"\x89PNG\r\n\x1a\n"
_RGB = 2  # IHDR colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img_u8: np.ndarray) -> bytes:
    """uint8 [H, W, 3] as the bytes of an 8-bit RGB PNG file."""
    a = np.asarray(img_u8, dtype=np.uint8)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"a PNG frame is [H, W, 3] uint8, got shape {a.shape}")
    h, w, _ = a.shape
    raw = np.zeros((h, 1 + w * 3), np.uint8)  # leading 0 = filter "none"
    raw[:, 1:] = a.reshape(h, w * 3)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _RGB, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(img_u8: np.ndarray, path: str | os.PathLike) -> None:
    """Write uint8 [H, W, 3] as an 8-bit RGB PNG."""
    data = encode_png(img_u8)
    with open(path, "wb") as f:
        f.write(data)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    rows = data.reshape(h, 1 + stride)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # sub: cumulative sum per byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # up
            cur = line + prev
        elif ftype in (3, 4):  # average / paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            lin, up = line.astype(np.int32), prev.astype(np.int32)
            zero = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                left = cur[x - bpp:x] if x else zero
                if ftype == 3:
                    pred = (left + up[x:x + bpp]) // 2
                else:
                    pred = _paeth(left, up[x:x + bpp], up[x - bpp:x] if x else zero)
                cur[x:x + bpp] = (lin[x:x + bpp] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str | os.PathLike) -> np.ndarray:
    """Read an 8-bit RGB PNG as uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype != _RGB or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB PNGs are supported "
                         f"(depth {depth}, colour type {ctype}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw, h, w * 3, 3).reshape(h, w, 3)


def list_pngs(folder: str | os.PathLike) -> list[str]:
    """The folder's *.png paths, sorted."""
    return sorted(glob.glob(os.path.join(str(folder), "*.png")))
