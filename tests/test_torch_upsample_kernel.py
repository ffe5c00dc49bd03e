"""Port's TF1 phase upsample (plain construction, dispatch, autograd) against JAX.

The CUDA kernel (``ops/cuda/upsample.py``) runs only on the card, where
``chip_smoke.py`` holds it bit-equal to the plain construction.  Here: the
plain construction is bit-equal to JAX's ``_upsample_phase_xla`` in float32
and bfloat16 (as tests/test_pallas_upsample.py holds the Pallas kernel); the
op ``iek::upsample_phase_tf1`` keeps CPU tensors on the plain construction
and sends CUDA tensors to the kernel, and the upsample refuses any other
device; the op's registered backward differentiates through the plain
construction, as JAX's ``_upsample_pallas_ad`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.ops import resize as jax_resize
from image_enhance_keras_tpu_torch.ops import resize
from image_enhance_keras_tpu_torch.ops.cuda import library
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
    """Forward through the op ``iek::upsample_phase_tf1`` (its CPU
    implementation, as no card is here; the launch must not run), whose
    registered backward is the kernel's gradient on the card: it equals
    JAX's vjp."""
    monkeypatch.setattr(ku, "_launch", lambda x, f: pytest.fail("the kernel ran on a CPU tensor"))
    xj, xt = _x((2, 5, 7, 8), jnp.float32, 2)
    g = np.random.default_rng(3).standard_normal((2, 20, 28, 8)).astype(np.float32)
    xt.requires_grad_(True)
    y = library.upsample_phase_tf1(xt, 4)
    assert "iek_upsample_phase_tf1" in type(y.grad_fn).__name__  # the registered backward, not plain autograd
    (grad,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda t: jax_resize._upsample_phase_xla(t, 4), xj)
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("factor", range(2, 9))
def test_weight_table_is_the_plain_weights(dtype, factor):
    """The table the kernel receives is the dtype's rounding of 1 - r/f and
    r/f exactly as upsample_phase_plain makes its weights."""
    tdt = DTYPES[dtype][1]
    w0, w1 = ku.weight_table(factor, tdt)
    assert len(w0) == len(w1) == factor
    for r in range(factor):
        assert w0[r] == torch.tensor(1.0 - r / factor, dtype=tdt).item()
        assert w1[r] == torch.tensor(r / factor, dtype=tdt).item()
        assert torch.tensor(w0[r], dtype=tdt).item() == w0[r]  # representable in the dtype


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("factor", [2, 4, 5])
def test_weight_tensor_is_the_table(dtype, factor):
    """The array the kernel reads: w0 at [0, f), w1 at [f, 2f), float32."""
    tdt = DTYPES[dtype][1]
    wt = ku.weight_tensor(factor, tdt, torch.device("cpu"))
    w0, w1 = ku.weight_table(factor, tdt)
    assert wt.dtype == torch.float32 and wt.is_contiguous()
    assert wt.tolist() == list(w0 + w1)


def _per_input_pixel(x: torch.Tensor, f: int) -> torch.Tensor:
    """The kernel's formulation: per input pixel (k, m), the four neighbours
    once, the f H-pass values of columns m and m1 (rounded to the dtype), then
    the f x f outputs, weights from the table, every step rounded."""
    n, h, w, c = x.shape
    w0, w1 = ku.weight_table(f, x.dtype)
    t = lambda v: torch.tensor(v, dtype=x.dtype)  # noqa: E731
    out = torch.empty((n, f * h, f * w, c), dtype=x.dtype)
    for k in range(h):
        k1 = min(k + 1, h - 1)
        for m in range(w):
            m1 = min(m + 1, w - 1)
            a, b, cc, d = x[:, k, m], x[:, k1, m], x[:, k, m1], x[:, k1, m1]
            for r in range(f):
                hm = a * t(w0[r]) + b * t(w1[r])
                hm1 = cc * t(w0[r]) + d * t(w1[r])
                for s in range(f):
                    out[:, f * k + r, f * m + s] = hm * t(w0[s]) + hm1 * t(w1[s])
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("factor", [2, 3, 4, 5])
def test_per_input_pixel_formulation_bit_equal_to_plain(dtype, factor):
    tdt = DTYPES[dtype][1]
    _, xt = _x((2, 5, 7, 8), DTYPES[dtype][0], factor + 10)
    xt = xt.to(tdt)
    got = _per_input_pixel(xt, factor)
    assert torch.equal(got, resize.upsample_phase_plain(xt, factor))
