"""Port's Light53 / Light chains against the JAX Pallas chain kernels.

The CUDA kernels (``csrc/tower.cu``) run only on the card: ``chip_smoke.py``
and tests/test_torch_cuda.py hold them against these plain versions there.  Here the wrappers take their plain versions
because the tensors lie on the CPU.  Tolerance 5e-5 as in
tests/test_pallas_tower.py: K float32 blocks summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.models.didbl_pallas import apply_didbl_pallas as jax_apply_pallas
from image_enhance_keras_tpu.ops.pallas.tower import fused_light53_chain as pallas_light53_chain
from image_enhance_keras_tpu.ops.pallas.tower import fused_light_chain as pallas_light_chain
from image_enhance_keras_tpu_torch.models.didbl_pallas import apply_didbl_pallas
from image_enhance_keras_tpu_torch.models.weights import params_from_numpy
from image_enhance_keras_tpu_torch.ops.cuda import blocks as kb
from image_enhance_keras_tpu_torch.ops.cuda import tower

C = 128
ATOL = 5e-5
#: which chain: (JAX kernel, port wrapper, port plain, block plain, kernel sizes, K, x shape, seed)
CHAINS = {
    "light53": (pallas_light53_chain, tower.fused_light53_chain, tower.light53_chain_plain,
                kb.light53_block_plain, (3, 5, 5, 3), 3, (2, 8, 8, C), 0),
    "light": (pallas_light_chain, tower.fused_light_chain, tower.light_chain_plain,
              kb.light_block_plain, (3, 3), 4, (1, 10, 6, C), 1),
}


def _inputs(which, device="cpu"):
    """numpy-seeded x and stacked (kernel, bias) pairs, He-scaled like flax's init."""
    _, _, _, _, sizes, k, shape, seed = CHAINS[which]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    args = []
    for ks in sizes:
        args.append((rng.normal(size=(k, ks, ks, C, C)) * (2.0 / (ks * ks * C)) ** 0.5).astype(np.float32))
        args.append((rng.normal(size=(k, C)) * 0.05).astype(np.float32))
    return x, args


@pytest.mark.parametrize("which", sorted(CHAINS))
def test_plain_chain_matches_pallas_chain(which):
    pallas, _, plain, *_ = CHAINS[which]
    x, args = _inputs(which)
    want = np.asarray(pallas(jnp.asarray(x), *(jnp.asarray(a) for a in args), interpret=True))
    got = plain(torch.from_numpy(x), *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("which", sorted(CHAINS))
def test_plain_chain_matches_sequential_blocks(which):
    _, _, plain, block, _, k, _, _ = CHAINS[which]
    x, args = _inputs(which)
    xt, at = torch.from_numpy(x), [torch.from_numpy(a) for a in args]
    want = xt
    for i in range(k):
        want = block(want, *(a[i] for a in at))
    np.testing.assert_allclose(plain(xt, *at).numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("which", sorted(CHAINS))
def test_cpu_wrapper_takes_plain_version(which):
    _, wrapper, plain, *_ = CHAINS[which]
    x, args = _inputs(which)
    xt, at = torch.from_numpy(x), [torch.from_numpy(a) for a in args]
    before = wrapper.launches
    assert torch.equal(wrapper(xt, *at), plain(xt, *at))
    assert wrapper.launches == before  # the count is of kernel launches only


def test_wrappers_reject_bad_args():
    x, args = _inputs("light")
    xt, at = torch.from_numpy(x), [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="stacked"):
        tower.fused_light_chain(xt, at[0][0], *at[1:])
    with pytest.raises(ValueError, match="bias shape"):
        tower.fused_light_chain(xt, at[0], at[1][:2], *at[2:])
    with pytest.raises(ValueError, match="kernel shape"):
        tower.fused_light_chain(xt, at[0], at[1], at[2][:2], at[3])
    with pytest.raises(TypeError, match="float32"):
        tower.fused_light_chain(xt.double(), *at)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tower.fused_light_chain(xt.to("meta"), *(a.to("meta") for a in at))


def test_didbl_chain_forward_matches_jax_chain_and_block_forward():
    """The narrow didbl through chain=True against JAX's chain=True (interpret)
    and the port's per-block kernel forward, at the whole forward's 3e-5."""
    blocks = dict(n_body53=2, n_light=1, n_tail53=1)
    x = np.random.default_rng(5).random((2, 12, 12, 3)).astype(np.float32)
    module = FlaxDidbl(features=16, **blocks)
    params = module.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    want = np.asarray(jax_apply_pallas(params, jnp.asarray(x), interpret=True, chain=True, **blocks))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    got = apply_didbl_pallas(pt, torch.from_numpy(x), chain=True, **blocks).numpy()
    assert got.shape == (2, 48, 48, 3)
    np.testing.assert_allclose(got, want, atol=3e-5)
    per_block = apply_didbl_pallas(pt, torch.from_numpy(x), **blocks).numpy()
    np.testing.assert_allclose(got, per_block, atol=3e-5)
