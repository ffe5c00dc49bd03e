"""The port's pixel shuffle (``ops/pixel_shuffle.py``) against the JAX package's on the CPU.

depth_to_space and space_to_depth are reshapes and permutes, so they are
held bit-equal to JAX's in both channel orders; icnr_init draws other
numbers than JAX's, so it is held to the structure ICNR promises: at
init, conv + depth_to_space equals a nearest-neighbour upsample of the
conv with the base filter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_enhance_keras_tpu.ops import pixel_shuffle as jps
from image_enhance_keras_tpu_torch.ops import pixel_shuffle as ps


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("order", ["dcr", "keras_ref"])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_depth_to_space_and_back_match_jax(r, order, batched):
    x = np.random.default_rng(r).normal(size=(2, 5, 7, r * r * 3)).astype(np.float32)
    x = x if batched else x[0]
    got = ps.depth_to_space(torch.from_numpy(x), r, order)
    want = np.asarray(jps.depth_to_space(jnp.asarray(x), r, order))
    np.testing.assert_array_equal(got.numpy(), want)
    back = ps.space_to_depth(got, r, order)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jps.space_to_depth(jnp.asarray(want), r, order)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_bad_shapes_and_orders_raise():
    with pytest.raises(ValueError, match="not divisible"):
        ps.depth_to_space(torch.zeros(1, 2, 2, 5), 2)
    with pytest.raises(ValueError, match="not divisible"):
        ps.space_to_depth(torch.zeros(1, 3, 4, 1), 2)
    with pytest.raises(ValueError, match="unknown order"):
        ps.depth_to_space(torch.zeros(1, 2, 2, 4), 2, "nope")
    with pytest.raises(ValueError, match="not divisible"):
        ps.icnr_init((3, 3, 4, 10), scale=2)


@pytest.mark.parametrize("order", ["dcr", "keras_ref"])
def test_icnr_init_is_nearest_resize_then_conv(order):
    """conv(x, icnr) then depth_to_space == nearest x r upsample of conv(x, base)."""
    r, cin, c = 4, 5, 3
    gen = torch.Generator().manual_seed(0)
    k = ps.icnr_init((3, 3, cin, c * r * r), scale=r, order=order, generator=gen)
    # every r*r group of output channels shares one base filter
    groups = k.reshape(3, 3, cin, r * r, c) if order == "dcr" else k.reshape(3, 3, cin, c, r * r).transpose(3, 4)
    base = groups[:, :, :, 0, :]
    assert torch.equal(groups, base[:, :, :, None, :].expand_as(groups))
    x = torch.randn(1, 6, 7, cin, generator=gen)

    def conv(w):
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)

    got = ps.depth_to_space(conv(k), r, order)
    want = conv(base).repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # the same draw from the same seed; the spread of flax's lecun_normal
    again = ps.icnr_init((3, 3, cin, c * r * r), scale=r, order=order, generator=torch.Generator().manual_seed(0))
    assert torch.equal(k, again)
    assert abs(float(base.std()) * (9 * cin) ** 0.5 - 1.0) < 0.35
