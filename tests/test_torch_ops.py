"""Port: ops, halo tiling, PNG codec, device rules and import hygiene, each
against the JAX package or its fixtures on the same numpy inputs.

Tolerance: f32 atol 1e-5. Measured max |diff| (CPU): conv2d 9.5e-7, head
tail 4.8e-7, enc/dec levels 0, resize 0, colour 0 (on [0, 255] values),
warp 0 against both JAX formulations and 6.1e-5 against the cv2 fixture
(bound 1e-3, as the JAX test), halo_map 0; conv_in_fused 0 against JAX at
strides 1, 2, 4 with and without `extra`, and 1.9e-6 against the port's own
concat + subsample composition; up_conv2x and its weight fold 0 against
JAX, 1.7e-6 against the port's upsample + conv on the interior; dec_level
with fast_upsample 0 against JAX.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fisr_tpu.infer import halo as jhalo
from fisr_tpu.ops import color as jcolor
from fisr_tpu.ops import conv as jconv
from fisr_tpu.ops import resize as jresize
from fisr_tpu.ops import warp as jwarp
from fisr_tpu_torch.convert.params import _load_tree_
from fisr_tpu_torch.infer.halo import halo_map
from fisr_tpu_torch.ops import color, conv, resize, warp

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _module(cls, tree, *args):
    return _load_tree_(cls(*args), _np_tree(tree))


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("stride,dilation,hw", [(1, 1, (12, 10)), (2, 1, (12, 10)),
                                                (2, 1, (11, 9)), (1, 4, (16, 16))])
def test_conv2d_matches_jax(stride, dilation, hw):
    p = jconv.init_conv(jax.random.PRNGKey(0), 3, 5, 7)
    p["b"] = jnp.asarray(_x(1, (7,)))
    x = _x(2, (2, *hw, 5))
    want = np.asarray(jconv.conv2d(p, jnp.asarray(x), stride=stride, dilation=dilation))
    got = conv.conv2d(_module(conv.Conv, p, 5, 7), torch.from_numpy(x),
                      stride=stride, dilation=dilation)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_enc_dec_levels_match_jax():
    k = jax.random.split(jax.random.PRNGKey(3), 2)
    pe = {"conv_in": jconv.init_conv(k[0], 3, 4, 6),
          "res0": jconv.init_res_block(k[1], 6), "res1": jconv.init_res_block(k[0], 6)}
    pd = {"resize": jconv.init_conv(k[1], 3, 6, 6), "conv_in": jconv.init_conv(k[0], 3, 12, 6),
          "res0": jconv.init_res_block(k[0], 6), "res1": jconv.init_res_block(k[1], 6)}
    x = _x(4, (1, 8, 12, 4))
    jpool, jskip = jconv.enc_level(pe, jnp.asarray(x))
    jdec = jconv.dec_level(pd, jpool, jskip, (8, 12))
    enc = _module(conv.EncLevel, pe, 4, 6)
    dec = _module(conv.DecLevel, pd, 6, 6)
    with torch.no_grad():
        pool, skip = conv.enc_level(enc, torch.from_numpy(x))
        out = conv.dec_level(dec, pool, skip, (8, 12))
    np.testing.assert_allclose(pool.numpy(), np.asarray(jpool), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jdec), rtol=0, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("with_extra", [False, True])
def test_conv_in_fused_matches_jax_and_composition(stride, with_extra):
    ci, ce = 5, 4 if with_extra else 0
    p = jconv.init_conv(jax.random.PRNGKey(20), 3, ci + ce, 7)
    p["b"] = jnp.asarray(_x(21, (7,)))
    img = _x(22, (2, 16, 24, ci))
    extra = _x(23, (2, 16 // stride, 24 // stride, ce)) if with_extra else None
    want = np.asarray(jconv.conv_in_fused(p, jnp.asarray(img),
                                          None if extra is None else jnp.asarray(extra),
                                          img_stride=stride))
    c = _module(conv.Conv, p, ci + ce, 7)
    with torch.no_grad():
        got = conv.conv_in_fused(c, torch.from_numpy(img),
                                 None if extra is None else torch.from_numpy(extra),
                                 img_stride=stride)
        sub = resize.downsample_int(torch.from_numpy(img), stride)
        composed = conv.conv2d(c, sub if extra is None
                               else torch.cat([sub, torch.from_numpy(extra)], -1))
    assert got.shape == want.shape == (2, 16 // stride, 24 // stride, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), composed.numpy(), rtol=0, atol=1e-5)


def test_up_conv2x_matches_jax_and_composition_on_interior():
    p = jconv.init_conv(jax.random.PRNGKey(24), 3, 8, 12)
    p["b"] = jnp.asarray(_x(25, (12,)))
    x = _x(26, (2, 16, 24, 8))
    c = _module(conv.Conv, p, 8, 12)
    # the fold, OIHW against the JAX package's HWIO
    want_w = np.asarray(jconv._fold_up_conv_weights(p["w"])).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(conv._fold_up_conv_weights(c.weight).detach().numpy(), want_w,
                               rtol=0, atol=1e-6)
    want = np.asarray(jconv.up_conv2x(p, jnp.asarray(x)))
    with torch.no_grad():
        got = conv.up_conv2x(c, torch.from_numpy(x)).numpy()
        composed = conv.conv2d(c, resize.upsample2x_bilinear(torch.from_numpy(x))).numpy()
    assert got.shape == (2, 32, 48, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # everywhere but the first row/column and the last two (tests/test_staged.py)
    np.testing.assert_allclose(got[:, 1:-2, 1:-2], composed[:, 1:-2, 1:-2], rtol=1e-5, atol=1e-5)
    assert np.abs(got - composed).max() > 1e-3  # the border does differ


def test_up_conv2x_folds_the_weight_it_is_given():
    """The weight is folded on every call: an in-place update shows in the
    next call (with autograd off, in inference mode and in another dtype),
    and with autograd on the fold is part of the graph."""
    c = conv.Conv(4, 6)
    with torch.no_grad():
        c.weight.copy_(torch.from_numpy(_x(31, (6, 4, 3, 3))))
    x = torch.from_numpy(_x(32, (1, 6, 8, 4)))
    with torch.no_grad():
        before = conv.up_conv2x(c, x)
        c.weight.mul_(2.0)
        torch.testing.assert_close(conv.up_conv2x(c, x) - c.bias, 2 * (before - c.bias))
        assert conv.up_conv2x(c, x, conv.BF16).dtype == torch.bfloat16
    conv.up_conv2x(c, x).sum().backward()
    assert c.weight.grad.abs().sum() > 0
    with torch.inference_mode():
        frozen = conv.Conv(4, 6)  # its weight is an inference tensor: no version counter
        a = conv.up_conv2x(frozen, x)
        frozen.weight.add_(1.0)
        assert not torch.equal(conv.up_conv2x(frozen, x), a)


def test_dec_level_fast_upsample_matches_jax():
    k = jax.random.split(jax.random.PRNGKey(27), 2)
    pd = {"resize": jconv.init_conv(k[1], 3, 6, 6), "conv_in": jconv.init_conv(k[0], 3, 12, 6),
          "res0": jconv.init_res_block(k[0], 6), "res1": jconv.init_res_block(k[1], 6)}
    x, skip = _x(28, (1, 8, 12, 6)), _x(29, (1, 16, 24, 6))
    dec = _module(conv.DecLevel, pd, 6, 6)
    for size, fast in (((16, 24), True), ((16, 24), False)):
        want = np.asarray(jconv.dec_level(pd, jnp.asarray(x), jnp.asarray(skip), size,
                                          fast_upsample=fast))
        with torch.no_grad():
            got = conv.dec_level(dec, torch.from_numpy(x), torch.from_numpy(skip), size,
                                 fast_upsample=fast)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # a size that is not a doubling keeps the resize whatever the flag says
    skip15 = _x(30, (1, 15, 23, 6))
    want = np.asarray(jconv.dec_level(pd, jnp.asarray(x), jnp.asarray(skip15), (15, 23),
                                      fast_upsample=True))
    with torch.no_grad():
        got = conv.dec_level(dec, torch.from_numpy(x), torch.from_numpy(skip15), (15, 23),
                             fast_upsample=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_max_pool_same_on_odd_extent():
    x = _x(5, (1, 5, 7, 3))
    want = np.asarray(jconv.max_pool_2x2(jnp.asarray(x)))
    np.testing.assert_array_equal(conv.max_pool_2x2(torch.from_numpy(x)).numpy(), want)


def test_depth_to_space_and_head_tail_match_jax():
    m = _x(6, (2, 5, 6, 16))
    want = np.asarray(jconv.depth_to_space(jnp.asarray(m), 2))
    np.testing.assert_array_equal(conv.depth_to_space(torch.from_numpy(m), 2).numpy(), want)
    p = jconv.init_conv(jax.random.PRNGKey(7), 3, 4, 3)
    p["b"] = jnp.asarray(_x(8, (3,)))
    want = np.asarray(jconv.head_tail_conv(p, jnp.asarray(m)))
    got = conv.head_tail_conv(_module(conv.Conv, p, 4, 3), torch.from_numpy(m))
    assert got.shape == (2, 10, 12, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size,method", [((6, 8), "bicubic"), ((24, 32), "bilinear"),
                                         ((9, 21), "bilinear"), ((30, 44), "bicubic"),
                                         ((48, 64), "bilinear")])
def test_resize_matches_jax(size, method):
    x = _x(9, (2, 12, 16, 3))
    want = np.asarray(jresize.resize_tf1(jnp.asarray(x), size, method))
    got = resize.resize_tf1(torch.from_numpy(x), size, method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_matches_tf_fixtures():
    import json

    with open(os.path.join(FIX, "tf_oracle", "manifest.json")) as f:
        cases = json.load(f)["resize_cases"]
    z = np.load(os.path.join(FIX, "tf_oracle", "resize.npz"))
    for i, case in enumerate(cases):
        got = resize.resize_tf1(torch.from_numpy(z[f"in_{i}"]), tuple(case["out"]),
                                case["method"]).numpy()
        # TF's legacy kernels quantise non-integer fractions to 1/1024 bins
        atol = 1e-5 if case["integer_factor"] else 5e-3
        np.testing.assert_allclose(got, z[f"out_{i}"], rtol=0, atol=atol, err_msg=str(case))
    z = np.load(os.path.join(FIX, "tf1_resize.npz"))
    for i, row in enumerate(z["cases"]):  # in_h, in_w, out_h, out_w
        ih, iw, oh, ow = (int(v) for v in row)
        integer = (ih % oh == 0 or oh % ih == 0) and (iw % ow == 0 or ow % iw == 0)
        x = torch.from_numpy(z[f"in_{i}"])
        for method in ("bilinear", "bicubic"):
            got = resize.resize_tf1(x, (oh, ow), method).numpy()
            atol = 1e-5 if (method == "bilinear" or integer) else 5e-3
            np.testing.assert_allclose(got, z[f"out_{i}_{method}"], rtol=0, atol=atol,
                                       err_msg=f"case {i} {method}")


def test_color_matches_jax():
    x = np.random.default_rng(10).uniform(-20, 275, size=(2, 5, 7, 3)).astype(np.float32)
    for fn, jfn in ((color.yuv2rgb_matlab, jcolor.yuv2rgb_matlab),
                    (color.rgb2yuv_matlab, jcolor.rgb2yuv_matlab)):
        for clip in (True, False):
            want = np.asarray(jfn(jnp.asarray(x), clip=clip))
            got = fn(torch.from_numpy(x), clip=clip).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    u8 = np.random.default_rng(11).integers(0, 256, size=(4, 6, 3), dtype=np.uint8)
    np.testing.assert_array_equal(color.yuv2rgb_matlab_u8(u8), jcolor.yuv2rgb_matlab_u8(u8))


def test_yuv2rgb_float_matches_jax():
    """The reference's float-constant YUV -> RGB, unclipped: values outside
    [0, 255] come out as they are."""
    x = np.random.default_rng(14).uniform(-20, 275, size=(3, 4, 6, 3)).astype(np.float32)
    got = color.yuv2rgb_float(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcolor.yuv2rgb_float(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    assert got.min() < 0 or got.max() > 255
    assert "yuv2rgb_float" in color.__all__


def test_warp_matches_jax_taps_and_patch():
    img = _x(12, (2, 9, 11, 4))
    flow = _x(13, (2, 9, 11, 2), scale=4.0)
    got = warp.dense_image_warp(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    for variant in ("taps", "patch"):
        want = np.asarray(jwarp.dense_image_warp(jnp.asarray(img), jnp.asarray(flow), variant))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=variant)


def test_warp_matches_cv2_fixture_and_is_differentiable():
    z = np.load(os.path.join(FIX, "tf_oracle", "warp_cv2.npz"))
    img = torch.from_numpy(z["img"][None]).requires_grad_(True)
    flow = torch.from_numpy(z["flow"][None] * 0.5).requires_grad_(True)
    out = warp.dense_image_warp(img, flow)
    np.testing.assert_allclose(out[0].detach().numpy(), z["warped_cv2"], rtol=0, atol=1e-3)
    out.sum().backward()
    assert img.grad.abs().sum() > 0 and flow.grad.abs().sum() > 0


def test_halo_map_matches_jax():
    p = jconv.init_conv(jax.random.PRNGKey(14), 3, 3, 4)
    x = _x(15, (2, 16, 24, 3))
    c = _module(conv.Conv, p, 3, 4)

    def jf(t):
        return jax.nn.leaky_relu(jconv.conv2d(p, t, stride=2), 0.1)

    want = np.asarray(jhalo.halo_map(jf, jnp.asarray(x), (2, 2), 6, (16, 24)))
    with torch.no_grad():
        got = halo_map(lambda t: torch.nn.functional.leaky_relu(conv.conv2d(c, t, stride=2), 0.1),
                       torch.from_numpy(x), (2, 2), 6, (16, 24)).numpy()
    assert got.shape == want.shape == (2, 8, 12, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a tuple out, as the tiled PWC estimator uses it; a half-scale input
    pair = halo_map(lambda t: (t * 2, t[:, ::2, ::2] + 1),
                    torch.from_numpy(x[:, ::2, ::2]), (2, 2), 4, (16, 24))
    np.testing.assert_array_equal(pair[0].numpy(), x[:, ::2, ::2] * 2)
    np.testing.assert_array_equal(pair[1].numpy(), x[:, ::4, ::4] + 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_png_codec_against_pil(tmp_path, seed):
    from PIL import Image

    from fisr_tpu_torch.data.png_io import list_pngs, read_png, write_png

    rng = np.random.default_rng(seed)
    # smooth plus noise, so that PIL's adaptive filtering picks every filter type
    yy, xx = np.mgrid[0:23, 0:37]
    img = (((xx * 7 + yy * 3)[..., None] + rng.integers(0, 3 + 60 * seed, size=(23, 37, 3)))
           % 256).astype(np.uint8)
    ours = tmp_path / "ours.png"
    write_png(img, ours)
    np.testing.assert_array_equal(np.array(Image.open(ours)), img)
    for optimize in (False, True):
        theirs = tmp_path / f"pil_{optimize}.png"
        Image.fromarray(img).save(theirs, optimize=optimize)
        np.testing.assert_array_equal(read_png(theirs), img)
    assert list_pngs(tmp_path) == sorted(str(p) for p in tmp_path.glob("*.png"))
    # every filter type, one per row cycle (PIL picks only some of them);
    # PIL decoding the file back to `img` checks the hand-filtered stream
    import struct
    import zlib

    def paeth(a, b, c):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        return a if pa <= pb and pa <= pc else (b if pb <= pc else c)

    h, w = img.shape[:2]
    rows, prev = [], np.zeros(w * 3, np.int64)
    for y in range(h):
        cur, ftype = img[y].reshape(-1).astype(np.int64), y % 5
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        pred = [np.zeros_like(cur), left, prev, (left + prev) // 2,
                np.array([paeth(*t) for t in zip(left, prev, upleft)])][ftype]
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    filtered = tmp_path / "filtered.png"
    filtered.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                         + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(np.array(Image.open(filtered)), img)
    np.testing.assert_array_equal(read_png(filtered), img)
    # greyscale decodes as PIL's convert("RGB"); a 16-bit sample does not decode
    Image.fromarray(img[..., 0]).save(tmp_path / "grey.png")
    np.testing.assert_array_equal(read_png(tmp_path / "grey.png"),
                                  np.array(Image.open(tmp_path / "grey.png").convert("RGB")))
    Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(tmp_path / "grey16.png")
    with pytest.raises(ValueError, match="8-bit"):
        read_png(tmp_path / "grey16.png")


def _filtered_png(img: np.ndarray, ftypes) -> bytes:
    """An 8-bit PNG of `img` ([H, W, C], C in 1, 3, 4) whose row y is
    filtered with ftypes[y], vectorised (every predictor reads the
    unfiltered image, as the encoder side of the PNG filters does)."""
    import struct
    import zlib

    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int64)
    up = np.vstack([np.zeros((1, w * c), np.int64), cur[:-1]])
    left = np.hstack([np.zeros((h, c), np.int64), cur[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int64), up[:, :-c]])
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(cur), left, up, (left + up) // 2, paeth])
    ft = np.asarray(ftypes, np.uint8)
    pred = np.take_along_axis(preds, ft[None, :, None].astype(np.int64), 0)[0]
    raw = np.hstack([ft[:, None], ((cur - pred) % 256).astype(np.uint8)])

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_decode_takes_each_colour_type_as_pil_converts_it(mode):
    """PIL-encoded frames of every colour type the server accepts decode to
    PIL's own `convert("RGB")` of them (alpha dropped, grey replicated,
    palette looked up), with PIL's adaptive filters and with all five filter
    types forced row by row."""
    import io

    from PIL import Image

    from fisr_tpu_torch.data.png_io import decode_png

    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:40, 0:56]
    base = (((xx * 5 + yy * 3)[..., None] + rng.integers(0, 30, (40, 56, 4))) % 256)
    img = Image.fromarray(base.astype(np.uint8), "RGBA")
    img = img.convert("RGB").quantize(64) if mode == "P" else img.convert(mode)
    for optimize in (False, True):
        buf = io.BytesIO()
        img.save(buf, format="PNG", optimize=optimize)
        got = decode_png(buf.getvalue())
        assert got.dtype == np.uint8 and got.shape == (40, 56, 3)
        np.testing.assert_array_equal(got, np.array(Image.open(buf).convert("RGB")))
    if mode in ("L", "RGB", "RGBA"):
        arr = np.array(img).reshape(40, 56, -1)
        data = _filtered_png(arr, [y % 5 for y in range(40)])
        want = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), want)


def test_png_decode_refuses_malformed_input():
    """What a client can send wrong: a header over PIL's bomb limit, image
    data longer or shorter than the header says (inflated no further than
    that), data that is not zlib, an interlaced or 16-bit image."""
    import struct
    import zlib

    from fisr_tpu_torch.data.png_io import decode_png

    def png(w, h, body, depth=8, ctype=2, interlace=0):
        def chunk(tag, data):
            return struct.pack(">I", len(data)) + tag + data + struct.pack(
                ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        return (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
                + chunk(b"IDAT", body) + chunk(b"IEND", b""))

    row = bytes(1 + 4 * 3)
    assert decode_png(png(4, 2, zlib.compress(row * 2))).shape == (2, 4, 3)
    cases = [(png(20000, 20000, zlib.compress(row)), "pixel limit"),
             (png(4, 2, zlib.compress(bytes(10 ** 7))), "holds more than 26 bytes"),
             (png(4, 2, zlib.compress(row)), "holds 13 bytes, its 4x2 header says 26"),
             (png(4, 2, b"not zlib"), "corrupt"),
             (png(4, 2, zlib.compress(row * 2), interlace=1), "interlace 1"),
             (png(4, 2, zlib.compress(row * 2), depth=16), "8-bit"),
             (png(4, 2, zlib.compress(bytes(5) * 2), ctype=3), "no PLTE"),
             (b"GIF89a", "not a PNG")]
    for data, match in cases:
        with pytest.raises(ValueError, match=match):
            decode_png(data)


def test_png_decode_of_a_2k_all_paeth_frame_is_exact_and_quick():
    """A 1024x1920 frame with every row Paeth-filtered (each pixel sequential
    on its left neighbour) decodes byte-exact in a vector step a diagonal:
    0.52-0.60 s on an 8-core Xeon, where a loop over pixels took 37 s
    (scripts/time_png_decode.py).
    The bound is loose on purpose (a shared CPU); it catches the loop."""
    import io
    import time

    from PIL import Image

    from fisr_tpu_torch.data.png_io import decode_png

    img = np.random.default_rng(0).integers(0, 256, (1024, 1920, 3), np.uint8)
    data = _filtered_png(img, [4] * 1024)
    np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(data))), img)
    t0 = time.perf_counter()
    got = decode_png(data)
    assert time.perf_counter() - t0 < 10.0
    np.testing.assert_array_equal(got, img)


def test_cuda_device_raises_without_a_card(monkeypatch, tmp_path):
    from fisr_tpu_torch import resolve_device
    from fisr_tpu_torch.infer.video import run_video_pipeline
    from fisr_tpu_torch.models.fisrnet import FISRnet
    from fisr_tpu_torch.models.pwcnet import PWCNet, PWCNetConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        FISRnet(ch=8)
    with pytest.raises(RuntimeError, match="cuda"):
        PWCNet(PWCNetConfig(pyr_lvls=3))
    fisr = FISRnet(ch=8, device="cpu")
    pwc = PWCNet(PWCNetConfig(pyr_lvls=3), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        run_video_pipeline(fisr, pwc, str(tmp_path), fused=True)
    assert resolve_device("cpu") == torch.device("cpu")


# ---- import hygiene: the port, chip_smoke.py and the port's scripts use no JAX

SCRIPTS = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "scripts", "profile_torch_video.py"),
           os.path.join(ROOT, "scripts", "time_torch_pipeline.py"),
           os.path.join(ROOT, "scripts", "time_cost_volume_variants.py"),
           os.path.join(ROOT, "scripts", "time_png_decode.py"),
           os.path.join(ROOT, "scripts", "time_torch_trained.py")]


def _port_files():
    files = list(SCRIPTS)
    for d, _, names in os.walk(os.path.join(ROOT, "fisr_tpu_torch")):
        files += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "orbax", "flax", "fisr_tpu")


def test_port_sources_import_no_jax():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append((path, node.module))
            elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
                bad.append((path, "importlib.import_module"))
    assert not bad, bad
    rel = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert {"fisr_tpu_torch/infer/tiled.py", "fisr_tpu_torch/infer/device.py",
            "fisr_tpu_torch/infer/evaluate.py", "fisr_tpu_torch/infer/video_eval.py",
            "fisr_tpu_torch/ops/metrics.py", "fisr_tpu_torch/ops/seq.py",
            "fisr_tpu_torch/data/flo.py", "fisr_tpu_torch/data/matio.py",
            "fisr_tpu_torch/cli/_common.py", "scripts/profile_torch_video.py",
            "fisr_tpu_torch/train/schedule.py", "fisr_tpu_torch/train/losses.py",
            "fisr_tpu_torch/train/trainer.py", "fisr_tpu_torch/train/checkpoint.py",
            "fisr_tpu_torch/train/loop.py", "fisr_tpu_torch/train/pwc_loss.py",
            "fisr_tpu_torch/train/pwc_trainer.py", "fisr_tpu_torch/train/joint.py",
            "fisr_tpu_torch/data/dataset.py", "fisr_tpu_torch/data/synth.py",
            "fisr_tpu_torch/data/augment.py", "fisr_tpu_torch/data/flow_dataset.py",
            "fisr_tpu_torch/utils/summary.py", "fisr_tpu_torch/utils/watchdog.py",
            "fisr_tpu_torch/utils/tb_writer.py", "fisr_tpu_torch/utils/flow_viz.py",
            "fisr_tpu_torch/utils/profiling.py", "fisr_tpu_torch/infer/autotune.py",
            "fisr_tpu_torch/infer/daemon.py", "fisr_tpu_torch/cli/serve.py",
            "fisr_tpu_torch/cli/tune.py", "fisr_tpu_torch/convert/orbax_read.py",
            "fisr_tpu_torch/convert/tensor_bundle.py", "fisr_tpu_torch/convert/tf_import.py",
            "fisr_tpu_torch/convert/cli.py", "fisr_tpu_torch/cli/prepare.py",
            "fisr_tpu_torch/cli/build_corpus.py", "fisr_tpu_torch/utils/supervisor.py"} <= rel
    assert len(rel) > 51


def test_port_modules_load_without_jax():
    """Every module of the port imports with no JAX loaded, and with h5py, PIL,
    triton, tensorstore and ml_dtypes made unimportable (the card's machine
    has no h5py, no PIL and no tensorstore; this one has no triton)."""
    mods = []
    for path in _port_files()[len(SCRIPTS):]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import importlib, sys\n"
        "for m in ('h5py', 'PIL', 'triton', 'tensorstore', 'ml_dtypes'): sys.modules[m] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'flax', 'fisr_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
