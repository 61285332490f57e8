"""The frozen reference against the port's CPU path at tiny shapes (the test
may import both; the reference itself imports nothing of the program), and
the plain PNG codec against the port's host codec."""

from __future__ import annotations

import numpy as np
import torch

from fisrbench.harness.runner import load_into, seeded_params
from fisrbench.reference import png
from fisrbench.reference.fisrnet import FISRnetRef
from fisrbench.reference.fisrnet import param_shapes as fisr_shapes
from fisrbench.reference.ops import yuv2rgb_u8
from fisrbench.reference.pwcnet import PWCNetRef
from fisrbench.reference.pwcnet import param_shapes as pwc_shapes

CPU = torch.device("cpu")


def test_fisrnet_matches_port():
    from fisr_tpu_torch.models import fisrnet

    p = seeded_params(fisr_shapes(29, 8, 2), torch.Generator().manual_seed(3), CPU)
    for k in p:
        if k.endswith("bias"):
            p[k] = torch.randn(p[k].shape, generator=torch.Generator().manual_seed(4)) * 0.1
    model = fisrnet.FISRnet(in_ch=29, sf=2, ch=8, seed=0, device="cpu")
    load_into(model, p)
    x = torch.rand((1, 64, 96, 29), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = fisrnet.apply(model, x)[2]
        got = FISRnetRef(p)(x)
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), (got - want).abs().max()


def test_pwcnet_matches_port():
    from fisr_tpu_torch.models import pwcnet

    cfg = dict(pyr_lvls=6, flow_pred_lvl=2, search_range=4, use_dense_cx=True, use_res_cx=True)
    p = seeded_params(pwc_shapes(**cfg), torch.Generator().manual_seed(6), CPU)
    model = pwcnet.PWCNet(pwcnet.PWCNetConfig(**cfg), seed=0, device="cpu")
    load_into(model, p)
    g = torch.Generator().manual_seed(7)
    a, b = torch.rand((2, 64, 128, 3), generator=g), torch.rand((2, 64, 128, 3), generator=g)
    with torch.no_grad():
        want, want_pyr = pwcnet.apply(model, a, b, model.cfg)
        got, got_pyr = PWCNetRef(p, **cfg)(a, b)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), (got - want).abs().max()
    for x, y in zip(got_pyr, want_pyr):
        assert torch.allclose(x, y, atol=1e-4, rtol=1e-4)


def test_png_codec_against_the_port():
    from fisr_tpu_torch.native import decode_png_bytes, encode_png_bytes, yuv2rgb_ops_u8

    img = np.random.default_rng(1).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    assert np.array_equal(png.decode(encode_png_bytes(img)), img)
    assert np.array_equal(decode_png_bytes(png.encode(img)), img)
    assert np.array_equal(yuv2rgb_u8(img), yuv2rgb_ops_u8(img))


def test_png_decode_every_filter():
    import struct
    import zlib

    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    h, w = img.shape[:2]
    rows, prev = [], np.zeros(3 * w, np.int32)
    for y in range(h):
        f = y % 5
        cur = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
        if f == 1:
            raw = cur - left
        elif f == 2:
            raw = cur - prev
        elif f == 3:
            raw = cur - (left + prev) // 2
        elif f == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            raw = cur - pred
        else:
            raw = cur
        rows.append(bytes([f]) + (raw & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    assert np.array_equal(png.decode(data), img)
