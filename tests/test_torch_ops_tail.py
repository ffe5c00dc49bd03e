"""The rest of the port's ``ops/`` against the JAX package on the CPU:
every resize method, ``upscale_bilinear_x4``, ``uniform_filter``,
``ops/adjust.py`` and ``ops/winograd.py``; profiling's ``StageTimer`` /
``trace`` / ``mpix_per_s``; and the package re-exports (the names of JAX's
``ops``, ``models`` and ``tiling`` ``__init__``).

Tolerances: the resize matrices within 1e-7 (both are numpy, so in fact
equal); ``resize_pil_uint8`` equal on seeded narrow inputs (the port sums
taps in JAX's CPU order; wide inputs keep the standing difference of
ROADMAP.md section 3); ``uniform_filter`` within 1e-6; ``set_contrast``
exact; ``set_gamma`` exact but for values where ``torch.pow`` and
``jnp.power`` differ in the last bit and that flips a .5 rounding, which
are counted and reported (one level each); ``winograd_conv2d_same`` within
JAX's own tolerances against the direct conv (``tests/test_winograd.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_enhance_keras_tpu.ops import adjust as jax_adjust
from image_enhance_keras_tpu.ops import filters as jax_filters
from image_enhance_keras_tpu.ops import resize as jax_resize
from image_enhance_keras_tpu.ops import winograd as jax_winograd
from image_enhance_keras_tpu_torch.ops import adjust, filters, resize, winograd

METHODS = ["tf1_bilinear", "tf1_bicubic", "tf1_nearest", "pil_nearest", "pil_bilinear", "pil_bicubic",
           "pil_lanczos", "pil_box"]
PIL_METHODS = [m for m in METHODS if m.startswith("pil_")]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("in_size,out_size", [(6, 24), (7, 21), (13, 5), (9, 9)])
def test_resize_weight_matrix_every_method(method, in_size, out_size):
    got = resize.resize_weight_matrix(in_size, out_size, method)
    want = jax_resize.resize_weight_matrix(in_size, out_size, method)
    assert got.dtype == want.dtype == np.float32 and got.shape == (out_size, in_size)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def test_unknown_method_raises_as_jax():
    with pytest.raises(ValueError, match="unknown resize method"):
        jax_resize.resize_weight_matrix(4, 8, "lanczos5")
    with pytest.raises(ValueError, match="unknown resize method"):
        resize.resize_weight_matrix(4, 8, "lanczos5")


@pytest.mark.parametrize("method", PIL_METHODS)
@pytest.mark.parametrize("out_hw", [(24, 20), (5, 7)])
def test_resize_pil_uint8_every_pil_method(method, out_hw):
    x = np.random.default_rng(5).integers(0, 256, (2, 12, 10, 3)).astype(np.uint8)
    want = np.asarray(jax_resize.resize_pil_uint8(jnp.asarray(x), out_hw, method))
    got = resize.resize_pil_uint8(torch.from_numpy(x), out_hw, method).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", METHODS)
def test_resize2d_every_method(method):
    """Float resizes are two contractions whose summation order may differ: 1e-5 at unit scale."""
    x = np.random.default_rng(6).normal(size=(1, 9, 7, 4)).astype(np.float32)
    want = np.asarray(jax_resize.resize2d(jnp.asarray(x), (15, 22), method))
    got = resize.resize2d(torch.from_numpy(x), (15, 22), method).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_resize2d_promotes_integers_as_jax():
    x = np.random.default_rng(7).integers(0, 256, (6, 5, 3)).astype(np.uint8)
    want = np.asarray(jax_resize.resize2d(jnp.asarray(x), (12, 10), "pil_bilinear"))
    got = resize.resize2d(torch.from_numpy(x), (12, 10), "pil_bilinear")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_upscale_bilinear_x4():
    x = np.random.default_rng(8).normal(size=(2, 5, 6, 8)).astype(np.float32)
    want = np.asarray(jax_resize.upscale_bilinear_x4(jnp.asarray(x)))
    got = resize.upscale_bilinear_x4(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 20, 24, 8)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("size", [3, 4, 7])
@pytest.mark.parametrize("shape", [(11, 9), (10, 12, 3), (2, 9, 8, 2)])
def test_uniform_filter(size, shape):
    x = np.random.default_rng(9).random(shape).astype(np.float32) * 255
    want = np.asarray(jax_filters.uniform_filter(jnp.asarray(x), size))
    got = filters.uniform_filter(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got / 255, want / 255, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["reflect", "edge", "constant", "wrap"])
def test_separable_filter2d_pad_modes(mode):
    x = np.random.default_rng(10).random((2, 9, 8, 3)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    want = np.asarray(jax_filters.separable_filter2d(jnp.asarray(x), k, pad_mode=mode))
    got = filters.separable_filter2d(torch.from_numpy(x), k, pad_mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("factor,pivot", [(1.7, 127.5), (0.6, 100.0), (2.5, 128.0)])
def test_set_contrast_exact(factor, pivot):
    img = np.arange(256, dtype=np.float32).reshape(16, 16)
    want = np.asarray(jax_adjust.set_contrast(jnp.asarray(img), factor, pivot))
    got = adjust.set_contrast(torch.from_numpy(img).to(torch.uint8), factor, pivot).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gamma", [0.4, 1.0, 2.2, 10.0])
def test_set_gamma_counts_half_flips(gamma):
    """Exact but where the two libraries' pow differ in the last bit and
    that flips a .5 rounding: one level, counted and reported."""
    img = np.random.default_rng(11).integers(0, 256, (64, 64, 3)).astype(np.float32)
    img[0, :, 0] = np.arange(64) * 4.0  # every quarter of the range, and the ends
    img[1, 0, :] = [0.0, 255.0, 128.0]
    want = np.asarray(jax_adjust.set_gamma(jnp.asarray(img), gamma))
    got = adjust.set_gamma(torch.from_numpy(img), gamma).numpy()
    diff = np.abs(got - want)
    flips = int((diff != 0).sum())
    print(f"set_gamma gamma={gamma}: {flips} of {img.size} values one level off")
    assert diff.max() <= 1.0
    if flips:
        x = img[diff != 0] / np.float32(255.0)
        y = np.power(x.astype(np.float64), gamma) * 255.0
        assert np.all(np.abs(y - np.floor(y) - 0.5) < 1e-4), "a difference away from a .5 boundary"
    assert flips <= img.size // 1000


def test_smooth_gan_labels_contract():
    """``jax.random`` draws cannot be reproduced in torch, so the test holds
    the contract: zeros land in [0, 0.3], ones in [0.7, 1.2], the same
    generator seed gives the same labels, different seeds different ones;
    JAX's function keeps the same ranges on the same labels."""
    y = torch.from_numpy(np.random.default_rng(12).integers(0, 2, (32, 2)).astype(np.float32))
    a = adjust.smooth_gan_labels(y, torch.Generator().manual_seed(3))
    b = adjust.smooth_gan_labels(y, torch.Generator().manual_seed(3))
    c = adjust.smooth_gan_labels(y, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    zeros, ones = a[y == 0], a[y == 1]
    assert zeros.numel() and ones.numel()
    assert zeros.min() >= 0 and zeros.max() <= 0.3 and ones.min() >= 0.7 and ones.max() <= 1.2
    j = np.asarray(jax_adjust.smooth_gan_labels(jnp.asarray(y.numpy()), jax.random.PRNGKey(0)))
    yn = y.numpy()
    assert j[yn == 0].max() <= 0.3 and j[yn == 1].min() >= 0.7


@pytest.mark.parametrize("m,k", [(2, 3), (4, 3), (2, 5), (3, 3), (2, 7)])
def test_winograd_transform_identity_float64(m, k):
    a_t, g, b_t = winograd._matrices_np(m, k)
    for got, want in zip((a_t, g, b_t), jax_winograd._matrices_np(m, k)):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(0)
    for _ in range(20):
        d, w = rng.standard_normal(m + k - 1), rng.standard_normal(k)
        y = a_t @ ((g @ w) * (b_t @ d))
        np.testing.assert_allclose(y, [np.dot(d[i : i + k], w) for i in range(m)], rtol=1e-9, atol=1e-9)
    assert winograd.flops_ratio(m, k) == jax_winograd.flops_ratio(m, k)
    for got, want in zip(winograd.winograd_matrices(m, k), jax_winograd.winograd_matrices(m, k)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k", [(2, 3), (2, 5), (4, 3)])
@pytest.mark.parametrize("hw", [(13, 17)])
def test_winograd_conv2d_same(m, k, hw):
    """Against JAX's winograd and the direct conv, at JAX's tolerance (2e-4),
    on sides that no tile of m divides."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *hw, 8)).astype(np.float32)
    w = (rng.standard_normal((k, k, 8, 16)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    got = winograd.winograd_conv2d_same(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), m=m)
    want = np.asarray(jax_winograd.winograd_conv2d_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), m=m))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    direct = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2).double(),
                      torch.from_numpy(w).permute(3, 2, 0, 1).double(), padding=k // 2)
    direct = (direct.permute(0, 2, 3, 1) + torch.from_numpy(b).double()).float()
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=2e-4, atol=2e-4)


def test_winograd_bf16_products():
    """bf16 operands, float32 sums: within JAX's 5% of the direct conv, and near JAX's own bf16 result."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 24, 24, 32)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 32, 32)) * 0.1).astype(np.float32)
    got = winograd.winograd_conv2d_same(torch.from_numpy(x), torch.from_numpy(w), None, m=2,
                                        dtype=torch.bfloat16).numpy()
    want = np.asarray(jax_winograd.winograd_conv2d_same(jnp.asarray(x), jnp.asarray(w), None, m=2,
                                                        dtype=jnp.bfloat16))
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.05
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_profiling_stage_timer_trace_and_rate(tmp_path):
    """``StageTimer.report()`` in JAX's format for the same totals; ``trace``
    writes a Chrome trace under its directory and yields it (CPU activity
    here); ``mpix_per_s`` as JAX's."""
    import json

    from image_enhance_keras_tpu.utils import profiling as jax_prof
    from image_enhance_keras_tpu_torch.utils import profiling

    got, want = profiling.StageTimer(), jax_prof.StageTimer()
    for t in (got, want):
        with t("decode"):
            pass
        t.totals.update({"decode": 0.25, "device": 1.5})
        t.counts.update({"decode": 2, "device": 3})
    assert got.report() == want.report()
    assert got.report().splitlines()[0] == "device: 1.500s / 3x (500.0 ms avg)"
    with profiling.trace(str(tmp_path / "tr")) as where:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert where == str(tmp_path / "tr")
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1 and "traceEvents" in json.loads(files[0].read_text())
    assert profiling.mpix_per_s(3_000_000, 1.5) == jax_prof.mpix_per_s(3_000_000, 1.5) == 2.0


@pytest.mark.parametrize("pkg", ["ops", "models", "tiling"])
def test_package_reexports(pkg):
    import importlib

    want = importlib.import_module(f"image_enhance_keras_tpu.{pkg}")
    got = importlib.import_module(f"image_enhance_keras_tpu_torch.{pkg}")
    names = {n for n in vars(want) if not n.startswith("_") and not isinstance(getattr(want, n), type(jax))}
    missing = sorted(n for n in names if not hasattr(got, n))
    assert not missing, missing
