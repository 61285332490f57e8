"""Port: the cost volume's plain version and kernel wrapper vs the JAX
package (XLA composition and the Pallas kernel in interpret mode).

Measured max |diff| on these inputs (f32, CPU): forward 1.8e-7, gradient
1.9e-6; bound atol 1e-5, as the JAX package's own kernel tests. The plain
backward (`cost_volume_backward`, the backward kernel's plain version) on
uniform [-1, 1) inputs: against autograd of `cost_volume` 4.8e-7 (bound
1e-6), against jax.vjp of the XLA composition and of the Pallas kernel 1e-5.

The index maps of the kernels (the bf16 kernel's 8-pixel tiles against
16-pixel c2 windows; the f32 kernel's staged rows, pixel groups and channel
split over a cluster; the f32 backward's streamed source rows, shared-memory
g runs at their 16-byte phase, register tiles and channel split; the bf16
backward's staged windows, ldmatrix.trans and mma lane maps, band entries at
the kernel's own offsets, channel chunks and tile choice; both backward
emulations with NaN in every slot the kernel does not stage) are emulated in
plain PyTorch and held against the plain version here (both backward
emulations at atol 1e-6: measured max |diff| 4.8e-7 f32, 3.0e-7 bf16's map);
the kernels themselves run in the `cuda`-marked tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fisr_tpu.kernels.cost_volume_pallas import cost_volume_pallas
from fisr_tpu.ops.cost_volume import cost_volume as jax_cost_volume
from fisr_tpu_torch.kernels import build
from fisr_tpu_torch.kernels import cost_volume as kernel
from fisr_tpu_torch.models import pwcnet
from fisr_tpu_torch.ops.cost_volume import cost_volume, cost_volume_backward

torch.set_num_threads(1)
BWD_SHAPES = [(1, 1, 1, 1), (2, 3, 3, 5), (2, 4, 7, 196), (2, 9, 53, 12)]


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("d", [2, 4])
def test_plain_matches_jax_and_pallas_interpret(d):
    a, b = _pair(0, (2, 16, 24, 8))
    got = cost_volume(torch.from_numpy(a), torch.from_numpy(b), d).numpy()
    assert got.shape == (2, 16, 24, (2 * d + 1) ** 2)
    want_xla = np.asarray(jax_cost_volume(jnp.asarray(a), jnp.asarray(b), d))
    want_pallas = np.asarray(cost_volume_pallas(jnp.asarray(a), jnp.asarray(b), d,
                                                interpret=True))
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [2, 4])
def test_plain_gradient_matches_jax(d):
    a, b = _pair(3, (1, 8, 12, 4))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    (cost_volume(ta, tb, d) ** 2).sum().backward()
    ga, gb = jax.grad(lambda x, y: jnp.sum(jax_cost_volume(x, y, d) ** 2),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=0, atol=1e-5)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    a, b = (torch.from_numpy(x) for x in _pair(1, (1, 5, 7, 3)))
    before, by_variant = kernel.LAUNCHES, dict(kernel.LAUNCHES_BY_VARIANT)
    assert torch.equal(kernel.cost_volume(a, b, 4), cost_volume(a, b, 4))
    assert kernel.LAUNCHES == before
    assert kernel.LAUNCHES_BY_VARIANT == by_variant
    assert set(by_variant) == {"mma_bf16", "fma_f32"}


def test_kernel_raises_for_cpu_tensors():
    a, b = (torch.from_numpy(x) for x in _pair(2, (1, 5, 7, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.cost_volume_cuda(a, b, 4)
    cv = pwcnet.PWCNetConfig(cost_volume_impl="kernel").cost_volume_fn()
    with pytest.raises(ValueError, match="CUDA"):
        cv(a, b)
    with pytest.raises(ValueError):
        pwcnet.PWCNetConfig(cost_volume_impl="pallas")


def test_plain_keeps_input_dtype_and_f32_arithmetic():
    a, b = (torch.from_numpy(x) for x in _pair(4, (1, 6, 9, 5)))
    got = cost_volume(a.bfloat16(), b.bfloat16(), 2)
    assert got.dtype == torch.bfloat16
    want = cost_volume(a.bfloat16().float(), b.bfloat16().float(), 2).bfloat16()
    assert torch.equal(got, want)


def test_ptxas_report_reads_spills_and_registers_per_kernel():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z27cost_volume_kernel_mma_bf16ILi4EEv' for 'sm_90a'
ptxas info    : Function properties for _Z27cost_volume_kernel_mma_bf16ILi4EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 125 registers, used 1 barriers
ptxas info    : Compile time = 128.448 ms
ptxas info    : Compiling entry function '_Z26cost_volume_kernel_fma_f32ILi2EEv' for 'sm_90a'
ptxas info    : Function properties for _Z26cost_volume_kernel_fma_f32ILi2EEv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 8 bytes cumulative stack size
"""
    assert build.ptxas_report(text) == [
        ("_Z27cost_volume_kernel_mma_bf16ILi4EEv",
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
         "Used 125 registers, used 1 barriers"),
        ("_Z26cost_volume_kernel_fma_f32ILi2EEv",
         "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
         "Used 72 registers, used 1 barriers, 8 bytes cumulative stack size")]
    assert build.ptxas_report("") == []


# ---- the backward's plain version --------------------------------------------

def _uniform(seed, shape, d):
    """c1, c2 [shape] and an output gradient, uniform in [-1, 1)."""
    rng = np.random.default_rng(seed)
    g_shape = tuple(shape[:3]) + ((2 * d + 1) ** 2,)
    return tuple(rng.uniform(-1, 1, size=s).astype(np.float32) for s in (shape, shape, g_shape))


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_plain_backward_matches_autograd(shape, d):
    a, b, g = (torch.from_numpy(x) for x in _uniform(6, shape, d))
    ta, tb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    want = torch.autograd.grad(cost_volume(ta, tb, d), (ta, tb), g)
    got = cost_volume_backward(a, b, g, d)
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == torch.float32
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_plain_backward_matches_jax_vjp(shape, d):
    a, b, g = _uniform(7, shape, d)
    got = cost_volume_backward(*(torch.from_numpy(x) for x in (a, b, g)), d)
    for fn in (lambda x, y: jax_cost_volume(x, y, d),
               lambda x, y: cost_volume_pallas(x, y, d, interpret=True)):
        _, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(b))
        for x, y in zip(got, vjp(jnp.asarray(g))):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,d", [((2, 9, 53, 12), 4), ((2, 4, 7, 196), 2)])
def test_plain_backward_bf16_within_one_ulp_of_autograd(shape, d):
    a, b, g = (torch.from_numpy(x).bfloat16() for x in _uniform(8, shape, d))
    ta, tb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    want = torch.autograd.grad(cost_volume(ta, tb, d), (ta, tb), g)
    got = cost_volume_backward(a, b, g, d)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == torch.bfloat16
        x, y = x.float(), y.float()
        assert ((x - y).abs() <= 1e-6 + 2.0**-7 * y.abs()).all()


def test_cpu_autograd_never_reaches_the_backward_kernel():
    a, b, g = (torch.from_numpy(x) for x in _uniform(9, (1, 5, 7, 3), 4))
    ta, tb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    before = (kernel.BACKWARD_LAUNCHES, dict(kernel.BACKWARD_LAUNCHES_BY_VARIANT))
    grads = torch.autograd.grad(kernel.cost_volume(ta, tb, 4), (ta, tb), g)
    for x, y in zip(grads, cost_volume_backward(a, b, g, 4)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    assert (kernel.BACKWARD_LAUNCHES, kernel.BACKWARD_LAUNCHES_BY_VARIANT) == before
    assert set(kernel.BACKWARD_LAUNCHES_BY_VARIANT) == {"bwd_f32", "bwd_bf16"}
    with pytest.raises(ValueError, match="CUDA"):
        kernel.cost_volume_backward_cuda(a, b, g, 4)


# ---- the tensor-core kernel's index map, emulated ----------------------------

def _banded_cost_volume(c1, c2, d, tile=8, window=16):
    """The cost volume the way csrc/cost_volume.cu's bf16 kernel takes it: per
    output row, dy and tile of `tile` pixels from x0, the tile x window product
    of the c1 pixels with the c2 pixels x0-d .. x0-d+window-1 of the
    zero-padded row y+dy; product element (n, p) with 0 <= p - n <= 2d is the
    cost of pixel x0+n at dx index p - n. Pixels of the last tile beyond W are
    dropped. The defaults are the kernel's shape."""
    b, h, w, c = c1.shape
    n = 2 * d + 1
    assert window >= tile + 2 * d
    wp = -(-w // tile) * tile
    c1p = torch.zeros(b, h, wp, c)
    c1p[:, :, :w] = c1
    c2p = torch.zeros(b, h + 2 * d, wp - tile + window, c)
    c2p[:, d:d + h, d:d + w] = c2
    rows, cols = torch.meshgrid(torch.arange(tile), torch.arange(window), indexing="ij")
    band = (cols - rows >= 0) & (cols - rows <= 2 * d)
    nn, pp = rows[band], cols[band]
    out = torch.zeros(b, h, wp, n * n)
    for x0 in range(0, wp, tile):
        c1_tile = c1p[:, :, x0:x0 + tile]
        for i in range(n):
            c2_window = c2p[:, i:i + h, x0:x0 + window]
            prod = torch.einsum("bhnc,bhpc->bhnp", c1_tile, c2_window)
            out[:, :, x0 + nn, i * n + (pp - nn)] = prod[:, :, nn, pp]
    return out[:, :, :w] / c


@pytest.mark.parametrize("shape,d", [((2, 9, 53, 12), 4), ((1, 7, 13, 3), 2),
                                     ((1, 1, 1, 1), 4),
                                     ((1, 2, 16, 4), 4),   # W a multiple of the tile: no tail
                                     ((1, 6, 70, 5), 2),   # d = 2 over many tiles
                                     ((1, 3, 5, 2), 4)])   # W below the tile and near d
def test_banded_tile_product_matches_plain(shape, d):
    a, b = (torch.from_numpy(x) for x in _pair(5, shape))
    got = _banded_cost_volume(a, b, d)
    want = cost_volume(a, b, d)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# ---- the f32 kernel's index map, emulated ------------------------------------

FR, FTX, FKC, FS, FMAX_SPLIT = 8, 16, 16, 20, 8  # csrc/cost_volume.cu, f32 kernel
H100_SMS = 132


def _fma_split(tiles, passes, sms=H100_SMS):
    """launch_fma_f32's channel split: blocks of a cluster on one tile."""
    split = 1
    while split < FMAX_SPLIT and tiles * split < 2 * sms and passes >= 2 * split:
        split *= 2
    return split


def _fma_tiled_cost_volume(c1, c2, d, sms=H100_SMS):
    """The cost volume the way the f32 kernel takes it: tiles of FR rows x FTX
    pixels; per channel pass of FKC, the staged buffers (c2 rows y0-d ..
    y0+FR-1+d of FTX+2d pixels plus one of padding, c1 rows of FTX pixels plus
    one, zeros outside the frame and beyond C); thread (dy index i, row r,
    pixels 4g+j) sums c1 staged pixel 4g+j against c2 staged pixel 4g+j+k of
    staged row r+i; the passes split over `split` ranks, whose partial tiles
    are added in rank order, times 1/C, cropped to the frame."""
    b, h, w, c = c1.shape
    n = 2 * d + 1
    tiles_y, tiles_x = -(-h // FR), -(-w // FTX)
    passes = -(-c // FKC)
    split = _fma_split(tiles_y * tiles_x * b, passes, sms)
    out = torch.zeros(b, h, w, n * n)
    # the frame inside zeros: the kernel's zero-filled copies outside it and
    # beyond C (the staged rows' padding pixel is never read)
    cp = passes * FKC
    c2p = torch.zeros(b, tiles_y * FR + 2 * d, tiles_x * FTX + 2 * d + 1, cp)
    c2p[:, d:d + h, d:d + w, :c] = c2
    c1p = torch.zeros(b, tiles_y * FR, tiles_x * FTX + 1, cp)
    c1p[:, :h, :w, :c] = c1
    for bb in range(b):
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                y0, x0 = ty * FR, tx * FTX
                tile = torch.zeros(FR, FTX, n * n)
                for rank in range(split):
                    part = torch.zeros(FR, FTX, n, n)
                    for p in range(rank * passes // split, (rank + 1) * passes // split):
                        c0 = p * FKC
                        kc = -(-min(FKC, c - c0) // 4) * 4
                        c2s = c2p[bb, y0:y0 + FR + 2 * d, x0:x0 + FTX + 2 * d + 1, c0:c0 + kc]
                        c1s = c1p[bb, y0:y0 + FR, x0:x0 + FTX + 1, c0:c0 + kc]
                        for i in range(n):
                            for k in range(n):
                                part[:, :, i, k] += (c1s[:, :FTX]
                                                     * c2s[i:i + FR, k:k + FTX]).sum(-1)
                    tile += part.reshape(FR, FTX, n * n)
                rows, cols = min(FR, h - y0), min(FTX, w - x0)
                out[bb, y0:y0 + rows, x0:x0 + cols] = (tile * (1.0 / c))[:rows, :cols]
    return out, split


@pytest.mark.parametrize("shape,d,split", [
    ((2, 9, 53, 12), 4, 1), ((1, 7, 13, 3), 2, 1), ((1, 1, 1, 1), 4, 1),
    ((2, 4, 7, 196), 4, 8),    # 13 passes over a cluster of 8: 2 or 1 a rank
    ((1, 6, 70, 40), 2, 2),    # 3 passes over 2 ranks; W over five tiles
    ((1, 9, 17, 20), 4, 2),    # W and H one past a tile; passes of 16 and 4, one a rank
    ((1, 3, 5, 2), 4, 1)])     # W below the tile and near d
def test_fma_tile_map_matches_plain(shape, d, split):
    a, b = (torch.from_numpy(x) for x in _pair(10, shape))
    got, used = _fma_tiled_cost_volume(a, b, d)
    assert used == split
    torch.testing.assert_close(got, cost_volume(a, b, d), rtol=0, atol=1e-5)


def test_fma_split_fills_the_card_at_the_inference_levels():
    """The 1024x1920 window's levels (x2 upscale, B=2): the small levels split
    their passes so that they launch two blocks an SM, or as near as a
    cluster of 8 takes them (level 6: 32 tiles x 8 = 256 blocks for 132 SMs)."""
    splits = {}
    for lvl, c in {2: 32, 3: 64, 4: 96, 5: 128, 6: 196}.items():
        h, w = 2048 >> lvl, 3840 >> lvl
        tiles = 2 * -(-h // FR) * -(-w // FTX)
        splits[lvl] = _fma_split(tiles, -(-c // FKC))
        assert tiles * splits[lvl] >= 2 * H100_SMS or splits[lvl] == FMAX_SPLIT
        assert tiles * splits[lvl] >= 256
    assert splits == {2: 1, 3: 1, 4: 1, 5: 4, 6: 8}


# ---- the f32 backward kernel's streamed rows and register tiles, emulated ------

BTILE_PX, BMAX_CQ, BMIN_THREADS = 32, 8, 32  # csrc/cost_volume.cu, cost_volume_bwd_f32
BWD_TILES = [(2, 2), (2, 1), (1, 2), (1, 1)]  # (tr, m): tr x tr for dc1, m*tr rows x tr for dc2
PWC_TRAIN_SHAPES = [(8, 256 >> lvl, 448 >> lvl, c)
                    for lvl, c in {2: 32, 3: 64, 4: 96, 5: 128, 6: 196}.items()]
JOINT_SHAPES = [(4, 192 >> lvl, 192 >> lvl, c)
                for lvl, c in {2: 32, 3: 64, 4: 96, 5: 128, 6: 196}.items()]


def _bwd_tile_choice(outputs, sms=H100_SMS):
    """bwd_tile_choice: the first (tr, m) of BWD_TILES whose threads give each
    SM 8 warps or more (2 tr^2 (1 + m) outputs a thread on the mean)."""
    for tr, m in BWD_TILES[:3]:
        if outputs // (2 * tr * tr * (1 + m)) >= 8 * 32 * sms:
            return tr, m
    return BWD_TILES[3]


def _bwd_plan(b, h, w, c, grads=2, sms=H100_SMS, tile=None):
    """bwd_plan: register tiles of tr pixels, tr rows for dc1 and m*tr for
    dc2; tiles of those rows x tx pixels (at most 32, as even as W allows,
    whole groups of tr); the channel chunk of 4*cq: the smallest power of two
    of quads that covers C, halved while the launch gives fewer than two
    blocks an SM."""
    p, m = _bwd_tile_choice(b * h * w * c * grads, sms) if tile is None else tile
    r1, r2 = p, m * p
    tiles_x = -(-w // BTILE_PX)
    pg = -(-(-(-w // tiles_x)) // p)
    tiles1, tiles2 = b * tiles_x * -(-h // r1), b * tiles_x * -(-h // r2)

    def blocks(cq):
        return (tiles1 + tiles2 * (grads == 2)) * -(-c // (4 * cq))

    cq = BMAX_CQ
    while cq > 1 and 4 * (cq // 2) >= c:
        cq //= 2
    while cq > 1 and blocks(cq) < 2 * sms:
        cq //= 2
    chunks = -(-c // (4 * cq))
    return {"r1": r1, "r2": r2, "p": p, "pg": pg, "cq": cq, "tx": pg * p,
            "threads": max(pg * cq, BMIN_THREADS), "tiles_x": tiles_x,
            "tiles_y1": -(-h // r1), "tiles_y2": -(-h // r2), "chunks": chunks,
            "blocks1": tiles1 * chunks, "blocks2": tiles2 * chunks, "blocks": blocks(cq)}


def _mod4(v):
    return v % 4  # Python's % is the kernel's non-negative mod4


def _streamed_backward(c1, c2, g, d, sms=H100_SMS, tile=None):
    """Both gradients the way cost_volume_bwd_f32 takes them, block by block:
    the plan above; dc2's blocks first, then dc1's, the chunk fastest; per
    block (tile of R rows: r1 for dc1, r2 for dc2; chunk) the source rows
    y0-d .. y0+R-1+d in the frame in order, each staged as a
    window of tx+2d pixels x the chunk's channels (zeros outside the frame
    and beyond C); g in flat shared-memory rows at each run's 16-byte phase
    (dc1: the tile's R rows, staged once; dc2: each source row's, with zeros
    for pixels outside the frame), every slot not staged holding NaN; all
    threads' register tiles (R rows x P pixels x 4 channels) at once as one
    [R, tx, 4*cq] sum, added to in the kernel's order (source row, staged
    pixel k, pixel p, row r) at shared-memory offset gb[r] + off; scaled by
    1/C and written out once, where the tile lies in the frame."""
    b, h, w, c = c1.shape
    n = 2 * d + 1
    nn = n * n
    pl = _bwd_plan(b, h, w, c, 2, sms, tile)
    tx, cq, pg, P = pl["tx"], pl["cq"], pl["pg"], pl["p"]
    kc, win = 4 * cq, tx + 2 * d
    g_row = -(-(win * nn + 3) // 4) * 4
    g_tile_row = -(-(tx * nn + 3) // 4) * 4
    gflat = g.reshape(-1)
    outs = [torch.full((b, h, w, c), float("nan")) for _ in range(2)]
    written = [torch.zeros((b, h, w, c), dtype=torch.int32) for _ in range(2)]
    groups = torch.arange(pg) * P
    for z in range(pl["blocks"]):
        which = 1 if z < pl["blocks2"] else 0
        z = z if which else z - pl["blocks2"]
        chunk, t = z % pl["chunks"], z // pl["chunks"]
        R, tiles_y = (pl["r2"], pl["tiles_y2"]) if which else (pl["r1"], pl["tiles_y1"])
        x0 = t % pl["tiles_x"] * tx
        y0 = t // pl["tiles_x"] % tiles_y * R
        bb = t // pl["tiles_x"] // tiles_y
        c0, img = chunk * kc, bb * h
        src = c2 if which == 0 else c1
        q_lo, q_hi = max(0, d - x0), min(win, w - x0 + d)
        chans = max(0, min(kc, c - c0))

        def g_run(dst, e_row, first, count):
            start = _mod4(e_row) + first
            dst[start:start + count] = gflat[e_row + first:e_row + first + count]

        if which == 0:
            gtile = torch.full((R * g_tile_row,), float("nan"))
            for r in range(R):
                if y0 + r < h:
                    g_run(gtile[r * g_tile_row:], ((img + y0 + r) * w + x0) * nn, 0,
                          min(tx, w - x0) * nn)
        acc = torch.zeros(R, tx, kc)
        for s in range(max(0, d - y0), min(R + 2 * d, h - y0 + d)):
            sy = y0 - d + s
            cwin = torch.zeros(win, kc)
            cwin[q_lo:q_hi, :chans] = src[bb, sy, x0 - d + q_lo:x0 - d + q_hi, c0:c0 + chans]
            if which == 1:
                grow = torch.full((g_row,), float("nan"))
                e_row = ((img + sy) * w + x0 - d) * nn
                g_run(grow, e_row, q_lo * nn, (q_hi - q_lo) * nn)
                sh = _mod4(e_row)
                grow[sh:sh + q_lo * nn] = 0.0
                grow[sh + q_hi * nn:sh + win * nn] = 0.0
            gb, live = [], []
            for r in range(R):
                i = s - r if which == 0 else r - s + 2 * d
                live.append(0 <= i < n)
                gb.append((r * g_tile_row + _mod4(((img + y0 + r) * w + x0) * nn) if which == 0
                           else _mod4(((img + sy) * w + x0 - d) * nn)) + i * n)
            gbuf = gtile if which == 0 else grow
            for k in range(P + 2 * d):
                v = cwin[groups + k]  # [pg, kc]: every thread's float4 of staged pixel k
                for p in range(P):
                    j = k - p if which == 0 else p + 2 * d - k
                    if not 0 <= j < n:
                        continue
                    pix = groups + (p if which == 0 else k)
                    for r in range(R):
                        if live[r]:
                            acc[r, groups + p] += gbuf[gb[r] + pix * nn + j, None] * v
        rows, cols = min(R, h - y0), min(tx, w - x0)
        outs[which][bb, y0:y0 + rows, x0:x0 + cols, c0:c0 + chans] = (
            acc[:rows, :cols, :chans] * (1.0 / c))
        written[which][bb, y0:y0 + rows, x0:x0 + cols, c0:c0 + chans] += 1
    for cnt in written:
        assert bool((cnt == 1).all())  # every output element written exactly once
    return tuple(outs), pl


@pytest.mark.parametrize("tile", BWD_TILES)
@pytest.mark.parametrize("shape,d", [((2, 9, 53, 12), 4), ((1, 7, 13, 3), 2),
                                     ((1, 1, 1, 1), 4), ((1, 2, 5, 70), 2),
                                     ((1, 3, 33, 33), 4),
                                     ((2, 16, 28, 12), 4)])  # pwc_train's level 4, narrowed
def test_backward_stream_map_matches_plain(shape, d, tile):
    a, b, g = (torch.from_numpy(x) for x in _uniform(12, shape, d))
    got, pl = _streamed_backward(a, b, g, d, tile=tile)
    assert (pl["r1"], pl["r2"]) == (tile[0], tile[0] * tile[1])
    for x, y in zip(got, cost_volume_backward(a, b, g, d)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_backward_stream_map_splits_channels_over_blocks():
    """With fewer SMs to fill the chunk stays at 32 channels; with the card's
    132 it shrinks to one quad: the same sums, split over 8 times the blocks."""
    a, b, g = (torch.from_numpy(x) for x in _uniform(13, (1, 4, 7, 30), 4))
    wide, wide_plan = _streamed_backward(a, b, g, 4, sms=1, tile=(2, 2))
    split, split_plan = _streamed_backward(a, b, g, 4, tile=(2, 2))
    assert (wide_plan["cq"], wide_plan["chunks"]) == (8, 1)
    assert (split_plan["cq"], split_plan["chunks"]) == (1, 8)
    for x, y in zip(wide, split):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", PWC_TRAIN_SHAPES + JOINT_SHAPES)
def test_backward_plan_fills_the_card_at_the_training_levels(shape):
    """Two blocks an SM or more at every level that the PWC and joint steps
    launch, both gradients asked for; tiles no wider than the frame needs."""
    pl = _bwd_plan(*shape)
    assert pl["blocks"] >= 2 * H100_SMS
    assert pl["tiles_x"] * pl["tx"] - shape[2] < pl["p"] * pl["tiles_x"]
    assert pl["blocks"] == pl["blocks1"] + pl["blocks2"]


def test_backward_plan_at_the_pwc_train_levels():
    """(dc1's tile rows, dc2's, tile width, chunk channels, blocks, threads a
    block) at levels 2..6 of a pwc_train step."""
    plans = [(p["r1"], p["r2"], p["tx"], 4 * p["cq"], p["blocks"], p["threads"])
             for p in (_bwd_plan(*s) for s in PWC_TRAIN_SHAPES)]
    assert plans == [(2, 4, 28, 32, 1536, 112), (2, 4, 28, 32, 768, 112),
                     (2, 2, 28, 32, 384, 112), (1, 2, 14, 32, 384, 112), (1, 1, 7, 32, 448, 56)]


# ---- the bf16 backward kernel's banded tensor-core products, emulated -------

QTX, QACC, QMIN_BLOCKS = 32, 16, 4  # csrc/cost_volume.cu, cost_volume_bwd_bf16
BF16_TILES = [(8, 8), (2, 4), (1, 1)]  # (dc1's tile rows, dc2's)


def _bf16_tile_choice(b, h, w, c, d, sms):
    """bwd_bf16_tile_choice: the tiles whose plan needs the fewest waves of
    QMIN_BLOCKS blocks an SM times the longest chain of source rows a block
    walks; the first of equals."""
    costs = []
    for tile in BF16_TILES:
        pl = _bf16_plan(b, h, w, c, d, sms, tile)
        waves = -(-pl["blocks"] // (QMIN_BLOCKS * sms))
        costs.append(waves * min(tile[1] + 2 * d, h + 2 * d))
    return BF16_TILES[costs.index(min(costs))]


def _bf16_plan(b, h, w, c, d=4, sms=H100_SMS, tile=None):
    """bwd_bf16_plan, both gradients asked for: tiles of r1 (dc1) or r2 (dc2)
    rows x 8 nt pixels (nt <= 4, as even as W allows); C's 16-channel m-tiles
    split evenly into chunks, at first the fewest whose m-tiles fit QACC //
    rows a thread, both counts then grown by one while the launch gives fewer
    than two blocks an SM."""
    r1, r2 = _bf16_tile_choice(b, h, w, c, d, sms) if tile is None else tile
    tiles_x = -(-w // QTX)
    nt = -(-(-(-w // 8)) // tiles_x)
    tiles1, tiles2 = b * tiles_x * -(-h // r1), b * tiles_x * -(-h // r2)
    mts = -(-c // 16)
    ch1, ch2 = -(-mts // (QACC // r1)), -(-mts // (QACC // r2))
    while tiles1 * ch1 + tiles2 * ch2 < 2 * sms and (ch1 < mts or ch2 < mts):
        ch1, ch2 = min(mts, ch1 + 1), min(mts, ch2 + 1)
    return {"r1": r1, "r2": r2, "nt": nt, "tiles_x": tiles_x, "tiles_y1": -(-h // r1),
            "tiles_y2": -(-h // r2), "mts": mts, "chunks1": ch1, "chunks2": ch2,
            "blocks1": tiles1 * ch1, "blocks2": tiles2 * ch2,
            "blocks": tiles1 * ch1 + tiles2 * ch2}


def _fragment_maps():
    """The lane maps of one warp's m16n8k16 product, from the PTX rules.
    ldmatrix.x4.trans: lane 8q+rr gives the address of row rr of matrix q,
    the kernel's a_off: staged pixel rr + 8 (q >> 1), channel 8 (q & 1); lane
    4g+t receives in register q column g of rows 2t and 2t+1. mma A register
    q of lane 4g+t holds A[g + 8 (q & 1)][2t + 8 (q >> 1) + half]; B register
    q holds B[2t + 8q + half][g]; D element e is D[g + 8 (e >> 1)][2t + (e & 1)].
    Returns (pixel, channel) of the staged window for each A[m][k], (k, n)
    for each lane's four band entries kk, and (pixel, channel) of the output
    tile for each D[m][n]."""
    a_pix, a_ch = torch.empty(16, 16, dtype=torch.long), torch.empty(16, 16, dtype=torch.long)
    b_k, b_n = torch.empty(32, 4, dtype=torch.long), torch.empty(32, 4, dtype=torch.long)
    d_pix, d_ch = torch.empty(16, 8, dtype=torch.long), torch.empty(16, 8, dtype=torch.long)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for q in range(4):
            for half in range(2):
                src = 8 * q + 2 * t + half  # the lane whose row address holds the value
                pix = (src & 7) + 8 * (src >> 4)
                ch = 8 * ((src >> 3) & 1) + g
                m, k = g + 8 * (q & 1), 2 * t + 8 * (q >> 1) + half
                a_pix[m, k], a_ch[m, k] = pix, ch
        for kk in range(4):
            b_k[lane, kk], b_n[lane, kk] = 2 * t + (kk & 1) + 8 * (kk >> 1), g
        for e in range(4):
            m, n = g + 8 * (e >> 1), 2 * t + (e & 1)
            # the kernel's stores o[0], o[s], o[8], o[s + 8]
            d_pix[m, n], d_ch[m, n] = 2 * t + (e & 1), g + 8 * (e >> 1)
    return a_pix, a_ch, b_k, b_n, d_pix, d_ch


def _round8(v):
    return -(-v // 8) * 8


def _banded_backward(c1, c2, g, d, sms=H100_SMS, tile=None):
    """Both gradients the way cost_volume_bwd_bf16 takes them, block by block:
    the plan above; dc2's blocks first, then dc1's, the chunk fastest; per
    block (tile of R rows x tx = 8 nt pixels, m-tiles m_lo .. m_hi - 1) the
    source rows y0-d .. y0+R-1+d in the frame in order, each staged as a
    window of tx+8 pixels x s = 16 (m_hi - m_lo) + 8 channels (zeros outside
    the frame and beyond C); g in flat shared-memory rows as the whole 8-value
    units that hold each run, at the run's phase (dc1: the tile's R rows;
    dc2: each source row's pixels in the frame). Every slot not staged holds
    NaN. Warp w (n-tile w, if it starts in the frame) builds A from the window
    through the ldmatrix.trans lane map and B from each lane's band entries
    (for dc2 zero where the staged pixel lies outside the frame), and adds
    A @ B in f32 for every live output row; D goes through its lane map into
    the output tile [R, tx, s], scaled by 1/C, and out where it lies in the
    frame."""
    b, h, w, c = c1.shape
    n = 2 * d + 1
    nn = n * n
    pl = _bf16_plan(b, h, w, c, d, sms, tile)
    nt, mts, tx = pl["nt"], pl["mts"], 8 * pl["nt"]
    win = tx + 8
    g_tile_row, g_row = _round8(tx * nn + 7), _round8(win * nn + 7)
    a_pix, a_ch, b_k, b_n, d_pix, d_ch = _fragment_maps()
    gq = b_n  # the lane's group: its B column
    t_lane = (b_k & 7) >> 1  # the lane's thread in group: k = 2t + c
    cs = b_k - 2 * t_lane  # c = 0, 1, 8, 9
    j = b_k - gq  # dc1's dx index of each band entry; dc2's is 2d - j
    gflat = g.reshape(-1)
    outs = [torch.full((b, h, w, c), float("nan")) for _ in range(2)]
    written = [torch.zeros((b, h, w, c), dtype=torch.int32) for _ in range(2)]

    def g_run(dst, e_row, first, count):
        """bf16_stage_g_run on a 16-byte aligned g: the whole 8-value units
        that hold the run, at the run's phase (Python's % is the kernel's
        non-negative mod8); a unit's values past g's end are NaN here."""
        e0 = e_row + first
        lo, hi = e0 - e0 % 8, -(-(e0 + count) // 8) * 8
        units = torch.full((hi - lo,), float("nan"))
        units[:min(hi, gflat.numel()) - lo] = gflat[lo:hi]
        start = e_row % 8 + first - e0 % 8
        dst[start:start + hi - lo] = units

    for z in range(pl["blocks"]):
        which = 1 if z < pl["blocks2"] else 0
        z = z if which else z - pl["blocks2"]
        chunks = pl["chunks2"] if which else pl["chunks1"]
        chunk, t = z % chunks, z // chunks
        R, tiles_y = (pl["r2"], pl["tiles_y2"]) if which else (pl["r1"], pl["tiles_y1"])
        x0 = t % pl["tiles_x"] * tx
        y0 = t // pl["tiles_x"] % tiles_y * R
        bb = t // pl["tiles_x"] // tiles_y
        img = bb * h
        m_lo, m_hi = chunk * mts // chunks, (chunk + 1) * mts // chunks
        mtc = m_hi - m_lo
        kc, c_lo = 16 * mtc, 16 * m_lo
        s = kc + 8
        chans = min(kc, c - c_lo)
        src = c2 if which == 0 else c1
        q_lo, q_hi = max(0, d - x0), min(win, w - x0 + d)
        if which == 0:
            gtile = torch.full((R * g_tile_row,), float("nan"))
            for r in range(R):
                if y0 + r < h:
                    g_run(gtile[r * g_tile_row:], ((img + y0 + r) * w + x0) * nn, 0,
                          min(tx, w - x0) * nn)
        acc = torch.zeros(R, nt, mtc, 16, 8)
        for st in range(max(0, d - y0), min(R + 2 * d, h - y0 + d)):
            sy = y0 - d + st
            ring = torch.full((win, s), float("nan"))
            ring[:, :kc] = 0.0
            ring[q_lo:q_hi, :chans] = src[bb, sy, x0 - d + q_lo:x0 - d + q_hi, c_lo:c_lo + chans]
            if which == 1:
                grow = torch.full((g_row,), float("nan"))
                g_run(grow, ((img + sy) * w + x0 - d) * nn, q_lo * nn, (q_hi - q_lo) * nn)
            for wp in range(nt):
                if x0 + 8 * wp >= w:
                    continue
                for r in range(R):
                    i = st - r if which == 0 else r - st + 2 * d
                    if not (0 <= i < n and y0 + r < h):
                        continue
                    # the kernel's addresses: lane term + row or step term + c step
                    if which == 0:  # g at the output pixel 8w + gq of row r, dx index k - gq
                        jj = j
                        lane_g = (8 * wp + gq) * nn + 2 * t_lane - gq
                        row_g = r * g_tile_row + ((img + y0 + r) * w + x0) * nn % 8 - r * n
                        idx = lane_g + st * n + row_g + cs
                        gbuf = gtile
                    else:  # g at the staged pixel 8w + k of this row, dx index gq + 2d - k
                        jj = 2 * d - j
                        lane_g = 8 * wp * nn + 2 * t_lane * (nn - 1) + gq + 2 * d
                        phase = ((img + sy) * w + x0 - d) * nn % 8
                        idx = lane_g + phase + (2 * d - st) * n + r * n + cs * (nn - 1)
                        gbuf = grow
                    band = (jj >= 0) & (jj < n)
                    if which == 1:  # and the staged pixel in the frame
                        band &= (8 * wp + b_k >= q_lo) & (8 * wp + b_k < q_hi)
                    bmat = torch.zeros(16, 8)
                    bmat[b_k[band], b_n[band]] = gbuf[idx[band]]
                    for mt in range(mtc):
                        amat = ring[8 * wp + a_pix, 16 * mt + a_ch]
                        acc[r, wp, mt] += amat @ bmat
        tile_out = torch.full((R, tx, s), float("nan"))
        for wp in range(nt):
            if x0 + 8 * wp < w:
                for mt in range(mtc):
                    tile_out[:, 8 * wp + d_pix, 16 * mt + d_ch] = acc[:, wp, mt] * (1.0 / c)
        rows, cols = min(R, h - y0), min(tx, w - x0)
        outs[which][bb, y0:y0 + rows, x0:x0 + cols, c_lo:c_lo + chans] = (
            tile_out[:rows, :cols, :chans])
        written[which][bb, y0:y0 + rows, x0:x0 + cols, c_lo:c_lo + chans] += 1
    for cnt in written:
        assert bool((cnt == 1).all())  # every output element written exactly once
    return tuple(outs), pl


@pytest.mark.parametrize("tile", BF16_TILES)
@pytest.mark.parametrize("shape,d", [((2, 9, 53, 12), 4), ((1, 7, 13, 3), 2),
                                     ((1, 1, 1, 1), 4), ((1, 2, 5, 70), 2),
                                     ((1, 3, 33, 33), 4),
                                     ((2, 4, 7, 196), 4),   # level 6's W and C: one n-tile, 13 m-tiles
                                     ((1, 5, 19, 40), 2)])  # d = 2, W off the n-tiles, a ragged m-tile
def test_backward_band_map_matches_plain(shape, d, tile):
    a, b, g = (torch.from_numpy(x) for x in _uniform(11, shape, d))
    got, pl = _banded_backward(a, b, g, d, tile=tile)
    assert (pl["r1"], pl["r2"]) == tile
    for x, y in zip(got, cost_volume_backward(a, b, g, d)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_backward_band_map_splits_channels_over_blocks():
    """With one SM to fill, C = 196's 13 m-tiles fill dc1's 2 chunks (6 and 7
    m-tiles: 8 fit a thread of its 2 rows) and dc2's 4 (3 or 4: 4 fit its 4
    rows); with the card's 132 both grow to one m-tile a block: the same
    sums, split over more blocks."""
    a, b, g = (torch.from_numpy(x) for x in _uniform(13, (1, 2, 7, 196), 4))
    wide, wide_plan = _banded_backward(a, b, g, 4, sms=1, tile=(2, 4))
    split, split_plan = _banded_backward(a, b, g, 4, tile=(2, 4))
    assert (wide_plan["chunks1"], wide_plan["chunks2"]) == (2, 4)
    assert (split_plan["chunks1"], split_plan["chunks2"]) == (13, 13)
    for x, y in zip(wide, split):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", PWC_TRAIN_SHAPES + JOINT_SHAPES)
def test_bf16_backward_plan_fills_the_card_at_the_training_levels(shape):
    """Two blocks an SM or more at every level that the PWC and joint steps
    launch, both gradients asked for; tiles no wider than the frame needs and
    no chunk with more m-tiles than a thread's QACC products allow."""
    pl = _bf16_plan(*shape)
    assert pl["blocks"] >= 2 * H100_SMS
    assert pl["tiles_x"] * 8 * pl["nt"] - shape[2] < 8 * pl["tiles_x"]
    for r, chunks in ((pl["r1"], pl["chunks1"]), (pl["r2"], pl["chunks2"])):
        assert chunks <= pl["mts"] and -(-pl["mts"] // chunks) * r <= QACC


def test_bf16_backward_plan_at_the_pwc_train_levels():
    """(dc1's tile rows, dc2's, tile width, chunks of dc1 and of dc2, blocks)
    at levels 2..6 of a pwc_train step: the tallest tile where the launch is
    large, a block's chain shortest where it is small."""
    plans = [(p["r1"], p["r2"], 8 * p["nt"], p["chunks1"], p["chunks2"], p["blocks"])
             for p in (_bf16_plan(*s) for s in PWC_TRAIN_SHAPES)]
    assert plans == [(8, 8, 32, 1, 1, 512), (2, 4, 32, 1, 1, 384), (1, 1, 32, 2, 2, 512),
                     (1, 1, 16, 3, 3, 384), (1, 1, 8, 5, 5, 320)]


# ---- on the card: the kernel against its plain version -----------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d", [((2, 16, 30, 32), 4), ((2, 8, 64, 32), 4),
                                     ((2, 9, 131, 196), 4), ((1, 7, 13, 3), 2),
                                     ((1, 1, 1, 1), 4), ((1, 5, 40, 20), 4),
                                     ((1, 6, 70, 96), 2)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, shape, d):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    b = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    got = kernel.cost_volume_cuda(a, b, d).float()
    want = cost_volume(a, b, d).float()
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:  # one bf16 rounding of f32 sums taken in another order
        assert ((got - want).abs() <= 1e-5 + 2.0**-7 * want.abs()).all()


@pytest.mark.cuda
def test_kernel_gradient_matches_plain_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    a = torch.randn((1, 8, 12, 4), device=cuda_device, generator=g, requires_grad=True)
    b = torch.randn((1, 8, 12, 4), device=cuda_device, generator=g, requires_grad=True)
    ga = torch.autograd.grad((kernel.cost_volume_cuda(a, b, 2) ** 2).sum(), (a, b))
    gp = torch.autograd.grad((cost_volume(a, b, 2) ** 2).sum(), (a, b))
    for x, y in zip(ga, gp):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic_on_card(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    a = torch.randn((2, 9, 131, 196), device=cuda_device, generator=g).to(dtype)
    b = torch.randn((2, 9, 131, 196), device=cuda_device, generator=g).to(dtype)
    assert torch.equal(kernel.cost_volume_cuda(a, b, 4), kernel.cost_volume_cuda(a, b, 4))


@pytest.mark.cuda
def test_kernel_handles_unaligned_views_on_card(cuda_device):
    """A contiguous view that starts 2 bytes into its storage takes the
    element-by-element staging instead of the 16-byte copies."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    shape = (1, 6, 20, 32)
    n = 6 * 20 * 32
    a = torch.randn(n + 1, device=cuda_device, generator=g).bfloat16()[1:].view(shape)
    b = torch.randn(n + 1, device=cuda_device, generator=g).bfloat16()[1:].view(shape)
    assert a.is_contiguous() and a.data_ptr() % 4 != 0
    got = kernel.cost_volume_cuda(a, b, 4).float()
    want = cost_volume(a, b, 4).float()
    assert ((got - want).abs() <= 1e-5 + 2.0**-7 * want.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "mma_bf16"),
                                           (torch.float32, "fma_f32")])
def test_launch_counts_by_variant_on_card(cuda_device, dtype, variant):
    a = torch.ones((1, 4, 8, 16), device=cuda_device, dtype=dtype)
    before = dict(kernel.LAUNCHES_BY_VARIANT)
    total = kernel.LAUNCHES
    kernel.cost_volume_cuda(a, a, 4)
    want = {k: v + (k == variant) for k, v in before.items()}
    assert kernel.LAUNCHES_BY_VARIANT == want
    assert kernel.LAUNCHES == total + 1


# ---- on the card: the backward kernel against its plain version --------------

def _card_triple(device, seed, shape, d, dtype):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(shape, device=device, generator=g).to(dtype)
    b = torch.randn(shape, device=device, generator=g).to(dtype)
    grad = torch.randn(tuple(shape[:3]) + ((2 * d + 1) ** 2,), device=device, generator=g)
    return a, b, grad.to(dtype)


def _assert_backward_close(got, want, dtype):
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == dtype
        x, y = x.float(), y.float()
        if dtype == torch.float32:
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        else:  # one bf16 rounding of f32 sums taken in another order
            assert ((x - y).abs() <= 1e-5 + 2.0**-7 * y.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d", [((1, 1, 1, 1), 4), ((2, 37, 53, 3), 2),
                                     ((2, 37, 53, 3), 4), ((2, 9, 131, 196), 4),
                                     ((1, 5, 40, 20), 4), ((4, 48, 48, 32), 4),
                                     ((2, 4, 7, 196), 4), ((1, 5, 19, 40), 2),
                                     ((2, 9, 53, 12), 4), ((1, 3, 33, 33), 4),
                                     ((1, 2, 5, 70), 2)]
                         + [(s, 4) for s in PWC_TRAIN_SHAPES])
def test_backward_kernel_matches_plain_on_card(cuda_device, dtype, shape, d):
    a, b, g = _card_triple(cuda_device, 4, shape, d, dtype)
    got = kernel.cost_volume_backward_cuda(a, b, g, d)
    want = cost_volume_backward(a, b, g, d)
    torch.cuda.synchronize()
    _assert_backward_close(got, want, dtype)
    # through autograd: the kernel's forward and backward, one gradient asked for
    ta = a.clone().requires_grad_(True)
    (only,) = torch.autograd.grad(kernel.cost_volume_cuda(ta, b, d), (ta,), g)
    assert torch.equal(only, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 131, 196)] + PWC_TRAIN_SHAPES)
def test_backward_kernel_is_deterministic_on_card(cuda_device, dtype, shape):
    a, b, g = _card_triple(cuda_device, 5, shape, 4, dtype)
    first = kernel.cost_volume_backward_cuda(a, b, g, 4)
    second = kernel.cost_volume_backward_cuda(a, b, g, 4)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_handle_unaligned_views_on_card(cuda_device, dtype):
    """Contiguous views that start one element into their storage: the f32
    forward takes its 4-byte copies, and the backward reads them as they are;
    a non-contiguous output gradient is made contiguous by the wrapper."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    shape = (1, 6, 20, 32)
    n = 6 * 20 * 32
    a, b = (torch.randn(n + 1, device=cuda_device, generator=gen).to(dtype)[1:].view(shape)
            for _ in range(2))
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    got = kernel.cost_volume_cuda(a, b, 4).float()
    want = cost_volume(a, b, 4).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert ((got - want).abs() <= 1e-5 + 2.0**-7 * want.abs()).all()
    g = torch.randn((1, 6, 81, 20), device=cuda_device, generator=gen).to(dtype).transpose(2, 3)
    assert not g.is_contiguous()
    _assert_backward_close(kernel.cost_volume_backward_cuda(a, b, g, 4),
                           cost_volume_backward(a, b, g, 4), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_takes_unaligned_g_on_card(cuda_device, dtype):
    """A contiguous output gradient that starts 3 elements into its storage:
    g's runs take the one-value-at-a-time copies instead of whole 16-byte
    units."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    shape = (2, 7, 21, 40)
    a, b = (torch.randn(shape, device=cuda_device, generator=gen).to(dtype) for _ in range(2))
    n = 2 * 7 * 21 * 81
    g = torch.randn(n + 3, device=cuda_device, generator=gen).to(dtype)[3:].view(2, 7, 21, 81)
    assert g.is_contiguous() and g.data_ptr() % 16 != 0
    _assert_backward_close(kernel.cost_volume_backward_cuda(a, b, g, 4),
                           cost_volume_backward(a, b, g, 4), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "bwd_bf16"),
                                           (torch.float32, "bwd_f32")])
def test_backward_launch_counts_by_variant_on_card(cuda_device, dtype, variant):
    a = torch.ones((1, 4, 8, 16), device=cuda_device, dtype=dtype, requires_grad=True)
    b = torch.ones((1, 4, 8, 16), device=cuda_device, dtype=dtype, requires_grad=True)
    out = kernel.cost_volume_cuda(a, b, 4)
    forward, by_variant = kernel.LAUNCHES, dict(kernel.LAUNCHES_BY_VARIANT)
    before, total = dict(kernel.BACKWARD_LAUNCHES_BY_VARIANT), kernel.BACKWARD_LAUNCHES
    out.sum().backward()
    want = {k: v + (k == variant) for k, v in before.items()}
    assert kernel.BACKWARD_LAUNCHES_BY_VARIANT == want
    assert kernel.BACKWARD_LAUNCHES == total + 1
    # backward launches are not forward launches
    assert (kernel.LAUNCHES, kernel.LAUNCHES_BY_VARIANT) == (forward, by_variant)
