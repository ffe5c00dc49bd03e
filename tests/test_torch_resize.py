"""Port's TF1 resize ops against the JAX package on the CPU.

``resize_bilinear_tf1`` is two float32 contractions with at most two
nonzero weights per row; the port and JAX may fuse the multiply-add
differently, so it is held to 1e-6.  ``upsample_phase_tf1`` repeats
``_upsample_phase_xla``'s products and sums one for one, so it is held
bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.ops import resize as jax_resize
from image_enhance_keras_tpu_torch.ops import resize

SHAPE = (2, 6, 7, 16)


def _x(seed=0):
    return np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)


@pytest.mark.parametrize("in_size,out_size", [(6, 24), (7, 28), (5, 13), (9, 4)])
def test_weight_matrix_equals_jax(in_size, out_size):
    np.testing.assert_array_equal(
        resize.resize_weight_matrix(in_size, out_size, "tf1_bilinear"),
        jax_resize.resize_weight_matrix(in_size, out_size, "tf1_bilinear"),
    )


@pytest.mark.parametrize("out_hw", [(24, 28), (13, 9)])
def test_resize_bilinear_tf1_matches_jax(out_hw):
    x = _x(1)
    want = np.asarray(jax_resize.resize_bilinear_tf1(jnp.asarray(x), out_hw))
    got = resize.resize_bilinear_tf1(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_upsample_phase_tf1_bit_equal_to_jax(factor):
    x = _x(2)
    want = np.asarray(jax_resize.upsample_phase_tf1(jnp.asarray(x), factor))
    got = resize.upsample_phase_tf1(torch.from_numpy(x), factor).numpy()
    np.testing.assert_array_equal(got, want)


def test_upsample_phase_equals_dense_resize():
    """The closed form and the dense contraction are the same TF1 resize."""
    x = torch.from_numpy(_x(3))
    a = resize.upsample_phase_tf1(x, 4)
    b = resize.resize_bilinear_tf1(x, (24, 28))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_other_methods_not_ported():
    """Every method is ported now: ``pil_lanczos``, once refused here, equals JAX's
    (the other methods: tests/test_torch_ops_tail.py)."""
    np.testing.assert_array_equal(resize.resize_weight_matrix(4, 8, "pil_lanczos"),
                                  jax_resize.resize_weight_matrix(4, 8, "pil_lanczos"))
