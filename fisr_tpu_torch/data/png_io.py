"""PNG frame I/O with the standard library (zlib + struct) and numpy: the
plain version of the host runtime's codec (fisr_tpu_torch/native), which the
pipeline, the server and the test phase use and which is held against this.

The FISR datasets keep YUV frames in ordinary 3-channel PNGs (the channels
are Y, U, V) and the video phase writes its predictions both as RGB and as
raw YUV PNGs, and the server's frames travel as PNGs. This codec reads
8-bit greyscale, grey + alpha, RGB, RGBA and palette PNGs, not interlaced,
every filter type, as RGB (`decode_png`, what PIL's convert("RGB") gives).
It writes 8-bit RGB with filter 0 (none) rows, zlib level 1: the 4K outputs
are large and encoding time, not file size, is what the video phase waits on.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib

import numpy as np

__all__ = ["read_png", "decode_png", "write_png", "encode_png", "list_pngs"]

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


# IHDR colour type -> bytes a pixel (8-bit samples)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# PIL's decompression-bomb limit (2 x Image.MAX_IMAGE_PIXELS): larger images raise
_MAX_PIXELS = 178_956_970


def _unfilter_diagonal(rows: np.ndarray, above: np.ndarray, w: int, bpp: int) -> np.ndarray:
    """Undo any mix of the five filters on `rows` ([n, 1 + w*bpp] bytes, the
    row before them decoded as `above`) -> [n, w*bpp].

    Pixel (y, x) depends on its left, upper and upper-left neighbours only, so
    the pixels of one anti-diagonal y + x = t are independent: the loop runs
    over the n + w - 1 diagonals, each decoded in one vector step whatever
    its rows' filter types. Buffers are skewed, diagonal-major: sk[t + 1,
    y + 1] is pixel (y, t - y); column 0 holds `above` (sk[x, 0] = pixel
    (-1, x)) and the cells left of column 0 stay zero, as the filters read
    them.
    """
    n = rows.shape[0]
    n_diag = n + w - 1
    # raw[y + x, y] = the filtered bytes of pixel (y, x)
    buf = np.zeros((n, n_diag + 1, bpp), np.int16)
    s = buf.strides
    np.lib.stride_tricks.as_strided(buf, (n, w, bpp), (s[0] + s[1], s[1], s[2]))[:] = \
        rows[:, 1:].reshape(n, w, bpp)
    raw = buf.transpose(1, 0, 2)
    sk = np.zeros((n_diag + 1, n + 1, bpp), np.int16)
    sk[:w, 0] = above.reshape(w, bpp)
    f = rows[:, :1].astype(np.int16)
    zero = np.zeros((1, bpp), np.int16)
    for t in range(n_diag):
        lo, hi = max(0, t - w + 1), min(n, t + 1)
        ft = f[lo:hi]
        a = sk[t, lo + 1:hi + 1]                # left (y, x - 1)
        b = sk[t, lo:hi]                        # up (y - 1, x)
        c = sk[t - 1, lo:hi] if t else zero     # up-left (y - 1, x - 1)
        p = a + b - c
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(ft == 4, paeth, np.where(ft == 3, (a + b) >> 1, np.where(
            ft == 2, b, np.where(ft == 1, a, 0))))
        sk[t + 1, lo + 1:hi + 1] = (raw[t, lo:hi] + pred) & 0xFF
    y, x = np.mgrid[0:n, 0:w]
    return sk[y + x + 1, y + 1].astype(np.uint8).reshape(n, w * bpp)


def _unfilter(data: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: [h * (1 + w*bpp)] bytes -> [h, w, bpp].

    None, Sub and Up rows take one vector step a row. Average and Paeth are
    sequential along the row, so the band from the first to the last such row
    goes through `_unfilter_diagonal` (all five types, one step a diagonal).
    """
    rows = data.reshape(h, 1 + w * bpp)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    out = np.zeros((h, w * bpp), np.uint8)
    seq = np.flatnonzero(ftype >= 3)
    band = range(seq[0], seq[-1] + 1) if seq.size else range(0)
    for y in range(h):
        if y in band:
            if y == band.start:
                above = out[y - 1] if y else np.zeros(w * bpp, np.uint8)
                out[y:band.stop] = _unfilter_diagonal(rows[y:band.stop], above, w, bpp)
            continue
        line = rows[y, 1:]
        if ftype[y] == 0:
            out[y] = line
        elif ftype[y] == 1:  # sub: cumulative sum per byte lane, mod 256
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:  # up
            out[y] = line + (out[y - 1] if y else 0)
    return out.reshape(h, w, bpp)


def _chunks(blob: bytes):
    pos = 8
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        yield blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        pos += 12 + n


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG file as uint8 [H, W, 3] RGB.

    Takes 8-bit greyscale, greyscale + alpha, RGB, RGBA and palette images,
    not interlaced, with every filter type, and gives what PIL's
    `Image.open(...).convert("RGB")` gives: grey replicated into three
    channels, alpha dropped, palette entries looked up. Anything else raises
    ValueError.
    """
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    hdr, idat, plte = None, [], None
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError("only 8-bit non-interlaced greyscale, RGB, RGBA or palette PNGs are "
                         f"supported (depth {depth}, colour type {ctype}, interlace {interlace})")
    if w * h > _MAX_PIXELS:
        raise ValueError(f"PNG of {w}x{h} pixels exceeds the {_MAX_PIXELS}-pixel limit")
    bpp = _CHANNELS[ctype]
    want = h * (1 + w * bpp)
    try:  # inflate no further than the header's size (a small body may expand without bound)
        raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat), want + 1), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    if raw.size != want:
        more = "more than " if raw.size > want else ""
        raise ValueError(f"PNG image data holds {more}{min(raw.size, want)} bytes, its "
                         f"{w}x{h} header says {want}")
    px = _unfilter(raw, h, w, bpp)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG has no PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(plte)] = plte[:256]
        return lut[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_png(path: str | os.PathLike) -> np.ndarray:
    """Read a PNG file as uint8 [H, W, 3] RGB (see `decode_png`)."""
    with open(path, "rb") as f:
        blob = f.read()
    try:
        return decode_png(blob)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def list_pngs(folder: str | os.PathLike) -> list[str]:
    """The folder's *.png paths, sorted."""
    return sorted(glob.glob(os.path.join(str(folder), "*.png")))
