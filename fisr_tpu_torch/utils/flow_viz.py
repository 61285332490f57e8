"""Optical-flow visualization + extra flow file formats (copy of
fisr_tpu/utils/flow_viz.py; numpy only).

Parity targets from the vendored tfoptflow:
* `flow_to_img` — Middlebury color-wheel rendering (optflow.py:190-258):
  hue from flow angle, saturation from magnitude normalized by the max
  (or a fixed `normalize_max`), HSV -> RGB uint8;
* `read_pfm` / `write_pfm` — FlyingThings-style PFM flow I/O
  (optflow.py:65-161 handles .flo/.png/.pfm; .flo lives in data/flo.py);
* `write_kitti_png` / `read_kitti_png` — KITTI 16-bit png flow encoding
  (u, v scaled by 64 + 2^15, third channel validity);
* `flow_panel` / `flow_panels` — the img1|img2|flow|warped|gt row composer
  behind training observability (visualize.plot_img_pairs_w_flows:18+ and
  OptFlowTBLogger.log_imgs_w_flows, logger.py:132-177) — pure numpy tile
  concatenation instead of a matplotlib figure (no text, no mpl dep; the
  information content is the tiles).
"""

from __future__ import annotations

import os
import re

import numpy as np

__all__ = ["flow_to_img", "read_pfm", "write_pfm", "read_kitti_png",
           "write_kitti_png", "flow_panel", "flow_panels"]


def _hsv_to_rgb_cv2_u8(h: np.ndarray, s: np.ndarray,
                       v: int = 255) -> np.ndarray:
    """OpenCV-semantics uint8 HSV->RGB: h in [0, 180), s/v in [0, 255].

    The standard sector formula with OpenCV's scaling (h*6/180) and
    round-half-even output (cvRound) — an independent numpy port of the
    cv2.cvtColor(..., COLOR_HSV2RGB) u8 path the reference renders
    flow images through (optflow.py:225)."""
    h6 = h.astype(np.float64) * (6.0 / 180.0)
    i = np.floor(h6).astype(int) % 6
    f = h6 - np.floor(h6)
    s1 = s.astype(np.float64) / 255.0
    vf = np.full(h.shape, float(v), np.float64)
    p = vf * (1.0 - s1)
    q = vf * (1.0 - s1 * f)
    t = vf * (1.0 - s1 * (1.0 - f))
    rgb = np.zeros(h.shape + (3,), np.float64)
    conds = [
        (i == 0, (vf, t, p)), (i == 1, (q, vf, p)), (i == 2, (p, vf, t)),
        (i == 3, (p, q, vf)), (i == 4, (t, p, vf)), (i == 5, (vf, p, q)),
    ]
    for cond, (r, g, b) in conds:
        rgb[..., 0] = np.where(cond, r, rgb[..., 0])
        rgb[..., 1] = np.where(cond, g, rgb[..., 1])
        rgb[..., 2] = np.where(cond, b, rgb[..., 2])
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def flow_to_img(flow: np.ndarray, normalize: bool = True,
                flow_mag_max: float | None = None) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] uint8 color-wheel image.

    Exact-semantics numpy port of the reference's cv2 pipeline
    (optflow.py:190-233): hue = angle from the +x axis in [0, 2pi)
    truncated to OpenCV's u8 hue range [0, 180); saturation = min-max
    normalized magnitude (cv2.normalize NORM_MINMAX) or
    mag*255/flow_mag_max; value = 255; OpenCV u8 HSV->RGB.
    cv2.cartToPolar's fast atan (~0.3 deg accuracy) vs our exact arctan2
    can move an occasional pixel by one hue count — pinned with that
    tolerance against the reference's own output in
    tests/test_optflow_oracle.py."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    mag = np.sqrt(u * u + v * v)
    ang = np.arctan2(v, u)
    # the reference zeroes NaN magnitudes after cartToPolar
    # (optflow.py:209-213: "A couple times, we've gotten NaNs out of the
    # above"); at saturation 0 the pixel renders white whatever its hue,
    # so the NaN angle is pinned to 0 too to keep the u8 cast defined
    # (the reference casts the NaN hue — undefined — but sat 0 makes it
    # invisible).
    nans = np.isnan(mag)
    if nans.any():
        mag = np.where(nans, 0.0, mag)
        ang = np.where(nans, 0.0, ang)
    ang = np.where(ang < 0.0, ang + 2.0 * np.pi, ang)
    hue = (ang * 180.0 / np.pi / 2.0).astype(np.uint8)
    if normalize:
        if flow_mag_max is None:
            lo, hi = float(mag.min()), float(mag.max())
            s_f = ((mag - lo) * (255.0 / (hi - lo)) if hi > lo
                   else np.zeros_like(mag))
        else:
            s_f = mag * 255.0 / flow_mag_max
    else:
        s_f = mag
    # the reference assigns the float into a u8 array: C-cast truncation.
    # In [0, 255] that is exactly astype(u8); above it (mag > flow_mag_max,
    # or normalize=False with mag > 255) the reference's out-of-range cast
    # is platform-dependent wrap — we clip to full saturation instead
    # (defined behavior; strongest flows stay strongest).
    sat = np.minimum(s_f, 255.0).astype(np.uint8)
    return _hsv_to_rgb_cv2_u8(hue, sat)


def _to_u8(img: np.ndarray) -> np.ndarray:
    """float [0,1] or uint8 [H, W, 3] -> uint8; grayscale is broadcast."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.dtype != np.uint8:
        img = (np.clip(img.astype(np.float64), 0.0, 1.0) * 255.0).astype(np.uint8)
    return img


def flow_panel(img1: np.ndarray, img2: np.ndarray, flow_pred: np.ndarray,
               warped: np.ndarray | None = None,
               flow_gt: np.ndarray | None = None,
               flow_mag_max: float | None = None,
               pad: int = 2) -> np.ndarray:
    """One observability row: [img1 | img2 | flow_pred | warped? | flow_gt?].

    Images are float [0,1] or uint8 [H, W, 3]; flows [H, W, 2] rendered via
    the Middlebury color wheel (`flow_to_img`) — pred and gt share one
    magnitude normalization so their saturations are comparable. Returns a
    uint8 [H, W_total, 3] strip with `pad`-px white separators — the numpy
    analog of plot_img_pairs_w_flows (visualize.py:18+).
    """
    if flow_mag_max is None:
        mags = [np.sqrt(np.sum(np.square(flow_pred.astype(np.float64)), -1))]
        if flow_gt is not None:
            mags.append(np.sqrt(np.sum(np.square(flow_gt.astype(np.float64)), -1)))
        flow_mag_max = max(float(np.max(m)) for m in mags) or 1e-9
    tiles = [_to_u8(img1), _to_u8(img2),
             flow_to_img(flow_pred, flow_mag_max=flow_mag_max)]
    if warped is not None:
        tiles.append(_to_u8(warped))
    if flow_gt is not None:
        tiles.append(flow_to_img(flow_gt, flow_mag_max=flow_mag_max))
    h = tiles[0].shape[0]
    sep = np.full((h, pad, 3), 255, np.uint8)
    out = []
    for i, t in enumerate(tiles):
        if i:
            out.append(sep)
        out.append(t)
    return np.concatenate(out, axis=1)


def flow_panels(img_pairs: np.ndarray, flow_preds: np.ndarray,
                warped: np.ndarray | None = None,
                flow_gts: np.ndarray | None = None,
                flow_mag_max: float | None = None,
                pad: int = 2) -> np.ndarray:
    """Stack one `flow_panel` row per batch sample into a single image.

    img_pairs: [B, 2, H, W, 3]; flow_preds: [B, H, W, 2]; warped/flow_gts
    optional [B, ...]. The batch analog of OptFlowTBLogger.log_imgs_w_flows
    (logger.py:132-177), composed into ONE image summary.
    """
    rows = [flow_panel(img_pairs[b, 0], img_pairs[b, 1], flow_preds[b],
                       None if warped is None else warped[b],
                       None if flow_gts is None else flow_gts[b],
                       flow_mag_max, pad)
            for b in range(len(img_pairs))]
    w = rows[0].shape[1]
    sep = np.full((pad, w, 3), 255, np.uint8)
    out = []
    for i, r in enumerate(rows):
        if i:
            out.append(sep)
        out.append(r)
    return np.concatenate(out, axis=0)


def write_pfm(path: str | os.PathLike, data: np.ndarray, scale: float = 1.0) -> None:
    data = np.asarray(data, np.float32)
    color = data.ndim == 3 and data.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())  # little endian
        np.flipud(data).tofile(f)


def read_pfm(path: str | os.PathLike):
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)), abs(scale)


def _png16_write(path, img_u16: np.ndarray) -> None:
    """Minimal 16-bit RGB PNG writer (PIL has no 16-bit RGB mode)."""
    import struct
    import zlib

    h, w, _ = img_u16.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)  # depth 16, RGB
    raw = img_u16.astype(">u2").tobytes()
    rows = b"".join(b"\x00" + raw[y * w * 6 : (y + 1) * w * 6] for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(rows)))
        f.write(chunk(b"IEND", b""))


def _png16_read(path) -> np.ndarray:
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a png")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 16 or ctype != 2:
                raise ValueError(f"{path}: expected 16-bit RGB")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 6 + 1
    rows = []
    for y in range(h):
        row = raw[y * stride : (y + 1) * stride]
        if row[0] != 0:
            raise ValueError(f"{path}: only filter 0 supported")
        rows.append(np.frombuffer(row[1:], dtype=">u2").reshape(w, 3))
    return np.stack(rows).astype(np.uint16)


def write_kitti_png(path: str | os.PathLike, flow: np.ndarray,
                    valid: np.ndarray | None = None) -> None:
    """KITTI flow encoding: uint16 png, (u, v)*64 + 2^15, ch3 = validity."""
    h, w = flow.shape[:2]
    enc = np.zeros((h, w, 3), np.uint16)
    enc[..., 0] = np.clip(flow[..., 0] * 64.0 + 2**15, 0, 65535).astype(np.uint16)
    enc[..., 1] = np.clip(flow[..., 1] * 64.0 + 2**15, 0, 65535).astype(np.uint16)
    enc[..., 2] = 1 if valid is None else valid.astype(np.uint16)
    _png16_write(path, enc)


def read_kitti_png(path: str | os.PathLike):
    enc = _png16_read(path).astype(np.float64)
    flow = np.stack([(enc[..., 0] - 2**15) / 64.0,
                     (enc[..., 1] - 2**15) / 64.0], axis=-1)
    valid = enc[..., 2].astype(bool)
    return flow.astype(np.float32), valid
