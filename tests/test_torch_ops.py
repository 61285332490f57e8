"""Port: ops, halo tiling, PNG codec, device rules and import hygiene, each
against the JAX package or its fixtures on the same numpy inputs.

Tolerance: f32 atol 1e-5. Measured max |diff| (CPU): conv2d 9.5e-7, head
tail 4.8e-7, enc/dec levels 0, resize 0, colour 0 (on [0, 255] values),
warp 0 against both JAX formulations and 6.1e-5 against the cv2 fixture
(bound 1e-3, as the JAX test), halo_map 0.
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
    Image.fromarray(img[..., 0]).save(tmp_path / "grey.png")
    with pytest.raises(ValueError, match="RGB"):
        read_png(tmp_path / "grey.png")


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


# ---- import hygiene: the port and chip_smoke.py use no JAX ------------------

def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "fisr_tpu_torch")):
        files += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "fisr_tpu")


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
    assert len(_port_files()) > 15


def test_port_modules_load_without_jax():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fisr_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
