"""A plain PNG codec (zlib and numpy): 8-bit RGB, every filter type on
decode, filter 0 on encode. The benchmark writes its input frames with it and
reads the program's output frames back with it."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(img: np.ndarray, level: int = 1) -> bytes:
    """u8 [H, W, 3] -> PNG bytes (filter 0 rows)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"RGB frames only, got {img.shape}")
    raw = np.empty((h, 1 + 3 * w), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def _paeth_row(raw, prev, bpp):
    out = np.zeros_like(raw, dtype=np.int32)
    prev = prev.astype(np.int32)
    for i in range(len(raw)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (int(raw[i]) + pred) & 0xFF
    return out.astype(np.uint8)


def _avg_row(raw, prev, bpp):
    out = np.zeros_like(raw, dtype=np.int32)
    for i in range(len(raw)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (int(raw[i]) + ((a + int(prev[i])) >> 1)) & 0xFF
    return out.astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB, not interlaced) -> u8 [H, W, 3]."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    off, idat, hdr = 8, [], None
    while off < len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[off + 8 + n:off + 12 + n])[0]:
            raise ValueError(f"bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        off += 12 + n
    if hdr is None:
        raise ValueError("no IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"8-bit RGB non-interlaced only, got {hdr}")
    stride = 3 * w
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + stride)
    filt = rows[:, 0]
    px = rows[:, 1:].copy()
    if not filt.any():
        return px.reshape(h, w, 3)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, raw = int(filt[y]), px[y]
        if f == 1:
            cur = raw.reshape(w, 3).cumsum(axis=0, dtype=np.uint8).reshape(stride)
        elif f == 2:
            cur = raw + prev
        elif f == 3:
            cur = _avg_row(raw, prev, 3)
        elif f == 4:
            cur = _paeth_row(raw, prev, 3)
        elif f == 0:
            cur = raw
        else:
            raise ValueError(f"filter type {f}")
        px[y] = cur
        prev = cur
    return px.reshape(h, w, 3)
