"""Port's TF1 phase upsample (plain construction, dispatch, autograd) against JAX.

The CUDA kernel (``ops/cuda/upsample.py``) runs only on the card, where
``chip_smoke.py`` holds it bit-equal to the plain construction.  Here: the
plain construction is bit-equal to JAX's ``_upsample_phase_xla`` in float32
and bfloat16 (as tests/test_pallas_upsample.py holds the Pallas kernel); the
dispatch keeps CPU tensors on the plain construction and sends every other
tensor to the kernel, which refuses anything but CUDA; the kernel's
autograd wrapper differentiates through the plain construction, as JAX's
``_upsample_pallas_ad`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.ops import resize as jax_resize
from image_enhance_keras_tpu_torch.ops import resize
from image_enhance_keras_tpu_torch.ops.cuda import upsample as ku

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _x(shape, jdt, seed=0):
    x = jnp.asarray((np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)).astype(jdt)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("factor", [2, 3, 4])
def test_plain_bit_equal_to_jax(dtype, factor):
    jdt, tdt = DTYPES[dtype]
    xj, xt = _x((2, 13, 21, 16), jdt, factor)
    want = np.asarray(jax_resize._upsample_phase_xla(xj, factor).astype(jnp.float32))
    got = resize.upsample_phase_plain(xt.to(tdt), factor)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_dispatch_stays_plain_on_cpu(monkeypatch):
    """Mirrors tests/test_pallas_upsample.py's off-TPU check: CPU never takes the kernel."""
    monkeypatch.setattr(ku, "_launch", lambda x, f: pytest.fail("the kernel ran on a CPU tensor"))
    _, xt = _x((1, 5, 6, 128), jnp.bfloat16, 1)
    xt = xt.to(torch.bfloat16)
    before = ku.upsample_phase_tf1_kernel.launches
    assert torch.equal(resize.upsample_phase_tf1(xt, 4), resize.upsample_phase_plain(xt, 4))
    assert ku.upsample_phase_tf1_kernel.launches == before


@pytest.mark.parametrize("shape", [(1, 5, 6, 128), (5, 6, 16)])
def test_dispatch_sends_device_tensors_to_kernel(shape):
    """A tensor off the CPU never takes the plain construction: it reaches the
    kernel, which refuses a device other than CUDA (here a meta tensor)."""
    with pytest.raises(ValueError, match="cuda tensors, not meta"):
        resize.upsample_phase_tf1(torch.zeros(shape, dtype=torch.bfloat16, device="meta"), 4)


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="cuda"):
        ku.upsample_phase_tf1_kernel(torch.zeros(1, 4, 4, 128), 4)


def test_kernel_autograd_is_transpose_of_plain(monkeypatch):
    """Forward through the autograd wrapper (the launch stubbed with the plain
    construction, as no card is here); its gradient equals JAX's vjp."""
    monkeypatch.setattr(ku, "_launch", resize.upsample_phase_plain)
    xj, xt = _x((2, 5, 7, 8), jnp.float32, 2)
    g = np.random.default_rng(3).standard_normal((2, 20, 28, 8)).astype(np.float32)
    xt.requires_grad_(True)
    y = ku.upsample_phase_tf1_kernel(xt, 4)
    (grad,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda t: jax_resize._upsample_phase_xla(t, 4), xj)
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5)
