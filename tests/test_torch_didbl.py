"""Port's didbl generator against the JAX package on the CPU.

Narrow config (features 16, 2 + 1 + 1 blocks, input 2x12x12x3), same numpy
weights through ``params_from_numpy``: the port's kernel forward (plain
block versions on the CPU) and module against JAX ``apply_didbl_pallas``
(interpret mode) and flax ``apply`` at 3e-5, as tests/test_didbl_pallas.py.
The committed demo checkpoint maps leaf for leaf onto the port's module,
and its real blocks match flax at 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from image_enhance_keras_tpu.models.blocks import Light53Block as FlaxLight53, LightBlock as FlaxLight
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.models.didbl_pallas import apply_didbl_pallas as jax_apply_pallas
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.didbl_pallas import apply_didbl_pallas
from image_enhance_keras_tpu_torch.models.weights import flatten_params, load_params, params_from_numpy
from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights
from image_enhance_keras_tpu_torch.train.checkpoints import load_params_npz

NARROW = dict(features=16, n_body53=2, n_light=1, n_tail53=1)
BLOCKS = dict(n_body53=2, n_light=1, n_tail53=1)


@pytest.fixture(scope="module")
def narrow():
    x = np.random.default_rng(0).random((2, 12, 12, 3)).astype(np.float32)
    module = FlaxDidbl(**NARROW)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return x, module, params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def demo():
    return load_params_npz(resolve_default_weights(MODEL_REGISTRY["didbl"]))


def test_kernel_forward_matches_jax_pallas_and_flax(narrow):
    x, module, params, pn = narrow
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    want_pallas = np.asarray(jax_apply_pallas(params, jnp.asarray(x), interpret=True, **BLOCKS))
    got = apply_didbl_pallas(params_from_numpy(pn), torch.from_numpy(x), **BLOCKS).numpy()
    assert got.shape == (2, 48, 48, 3)
    np.testing.assert_allclose(got, want_pallas, atol=3e-5)
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_module_matches_flax(narrow):
    x, module, params, pn = narrow
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    mod = DifvdsrDouble(**NARROW)
    load_params(mod, pn)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
        split = mod.tail(mod.body(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)
    np.testing.assert_array_equal(split, got)
    assert mod.split_halo == module.split_halo


def test_demo_checkpoint_maps_every_leaf(demo):
    flat = flatten_params(params_from_numpy(demo))
    assert len(flat) == 172
    assert all(v.dtype == torch.float32 for v in flat.values())
    shapes = jax.eval_shape(
        lambda: FlaxDidbl().init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    )
    want = {k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    mod = DifvdsrDouble()
    load_params(mod, demo)
    assert {n.replace(".", "/"): tuple(p.shape) for n, p in mod.named_parameters()} == want


def _flax_conv(features, k):
    return nn.Conv(features, (k, k), padding="SAME")


@pytest.mark.parametrize("name", ["level1", "body53_0", "light_0", "tail53_0", "out"])
def test_demo_blocks_match_flax(demo, name):
    rng = np.random.default_rng(7)
    flax_mod = {
        "level1": _flax_conv(128, 1), "out": _flax_conv(3, 3),
        "light_0": FlaxLight(128),
    }.get(name, FlaxLight53(128))
    x = rng.random((1, 8, 8, 3 if name == "level1" else 128)).astype(np.float32)
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), demo[name])
    want = np.asarray(flax_mod.apply({"params": pj}, jnp.asarray(x)))
    mod = DifvdsrDouble()
    load_params(mod, demo)
    with torch.no_grad():
        got = getattr(mod, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="is not a profile"):
        DifvdsrDouble(upsampler="subpixel", dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="is not a profile"):
        DifvdsrDouble(dtype=torch.float16, mixed=True)
    with pytest.raises(NotImplementedError, match="is not a profile"):
        apply_didbl_pallas({}, torch.zeros(1, 4, 4, 3), dtype=torch.float16, chain=True)
    with pytest.raises(NotImplementedError, match="is not a profile"):
        DifvdsrDouble(dtype=torch.float16, mixed_tail=True)
