"""Port: the cost volume's plain version and kernel wrapper vs the JAX
package (XLA composition and the Pallas kernel in interpret mode).

Measured max |diff| on these inputs (f32, CPU): forward 1.8e-7, gradient
1.9e-6; bound atol 1e-5, as the JAX package's own kernel tests.

The bf16 kernel's index map (8-pixel tiles against 16-pixel c2 windows, the
band's diagonals) is emulated in plain PyTorch and held against the plain
version here; the kernel itself runs in the `cuda`-marked tests.
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
from fisr_tpu_torch.ops.cost_volume import cost_volume

torch.set_num_threads(1)


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
