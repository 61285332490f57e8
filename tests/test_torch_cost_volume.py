"""Port: the cost volume's plain version and kernel wrapper vs the JAX
package (XLA composition and the Pallas kernel in interpret mode).

Measured max |diff| on these inputs (f32, CPU): forward 1.8e-7, gradient
1.9e-6; bound atol 1e-5, as the JAX package's own kernel tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fisr_tpu.kernels.cost_volume_pallas import cost_volume_pallas
from fisr_tpu.ops.cost_volume import cost_volume as jax_cost_volume
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
    before = kernel.LAUNCHES
    assert torch.equal(kernel.cost_volume(a, b, 4), cost_volume(a, b, 4))
    assert kernel.LAUNCHES == before


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


# ---- on the card: the kernel against its plain version -----------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d", [((2, 16, 30, 32), 4), ((2, 9, 131, 196), 4),
                                     ((1, 7, 13, 3), 2), ((1, 1, 1, 1), 4)])
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
