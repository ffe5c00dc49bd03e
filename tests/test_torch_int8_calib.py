"""Port's int8 calibration chain and int8 didbl forward against the JAX package.

Calibration inputs (PIL-bicubic degradation of bundled photos or procedural
images) must equal JAX's; ``quantize_didbl_params`` on the same input gives
bit-equal int8 codes and activation scales within relative 1e-5 (float32
sums in another order).  ``apply_didbl_int8`` runs on JAX's quantized tree
carried across, against JAX's forward with its Pallas kernels in interpret
mode: bf16 activations between blocks and the bf16 level1/out convs round
differently in the two frameworks, so the bound is mean |diff| <= 5e-4 and
max |diff| <= 1e-2 on outputs in [0, 1].  Narrow model (features 16,
2 + 1 + 1 blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.data import pipeline as jax_pipeline
from image_enhance_keras_tpu.models import didbl_pallas as jax_dp
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.ops import resize as jax_resize
from image_enhance_keras_tpu_torch.data import pipeline
from image_enhance_keras_tpu_torch.models import didbl_pallas as dp
from image_enhance_keras_tpu_torch.models.weights import flatten_params, params_from_numpy
from image_enhance_keras_tpu_torch.ops import resize

BLOCKS = dict(n_body53=2, n_light=1, n_tail53=1)
ACT_RTOL = 1e-5


@pytest.fixture(scope="module")
def narrow():
    """Narrow params (numpy), a calibration batch and a serving batch in [0, 1]."""
    module = FlaxDidbl(features=16, **BLOCKS)
    params = module.init(jax.random.PRNGKey(5), jnp.zeros((1, 16, 16, 3)))["params"]
    rng = np.random.default_rng(9)
    calib = rng.random((2, 20, 20, 3)).astype(np.float32)
    x = rng.random((2, 12, 14, 3)).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, params), calib, x


@pytest.fixture(scope="module")
def quantized(narrow):
    pn, calib, _ = narrow
    want = jax_dp.quantize_didbl_params(jax.tree_util.tree_map(jnp.asarray, pn),
                                        calib_x=jnp.asarray(calib), **BLOCKS)
    got = dp.quantize_didbl_params(params_from_numpy(pn), calib_x=torch.from_numpy(calib), **BLOCKS)
    return flatten_params(jax.tree_util.tree_map(np.asarray, want)), flatten_params(got), want


@pytest.mark.parametrize("in_size,out_size", [(427, 106), (640, 160), (33, 8), (32, 128)])
def test_pil_bicubic_matrix_equals_jax(in_size, out_size):
    np.testing.assert_array_equal(
        resize.resize_weight_matrix(in_size, out_size, "pil_bicubic"),
        jax_resize.resize_weight_matrix(in_size, out_size, "pil_bicubic"),
    )


@pytest.mark.parametrize("hw,out_hw", [((64, 48), (16, 12)), ((37, 29), (9, 7))])
def test_resize_pil_uint8_bit_equal_to_jax(hw, out_hw):
    img = np.random.default_rng(1).integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = np.asarray(jax_resize.resize_pil_uint8(jnp.asarray(img, jnp.float32), out_hw))
    got = resize.resize_pil_uint8(torch.from_numpy(img), out_hw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gen,args", [
    ("synthetic_images", (4, 128)),
    ("rich_synthetic_images", (8, 256, 17)),
    ("builtin_photos", ()),
])
def test_calibration_images_equal_jax(gen, args):
    got, want = getattr(pipeline, gen)(*args), getattr(jax_pipeline, gen)(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def test_weight_codes_bit_equal_and_scales_close(quantized):
    want, got, _ = quantized
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].numpy()
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "q":
            assert g.dtype == np.int8
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif leaf in ("act", "x", "a", "b", "t"):  # act, and actc's per-channel vectors
            np.testing.assert_allclose(g, w, rtol=ACT_RTOL, err_msg=key)
        elif leaf == "qf":  # codes of weights scaled by actc: a code may flip at a .5
            assert (g != w).mean() <= 1e-3 and np.abs(g.astype(int) - w).max() <= 1, key
        else:  # s, sf, bias, level1/out kernels and biases
            np.testing.assert_allclose(g, w, rtol=ACT_RTOL, err_msg=key)


def test_apply_didbl_int8_on_jax_qparams(narrow, quantized):
    _, _, x = narrow
    _, _, jq = quantized
    want = np.asarray(jax_dp.apply_didbl_int8(jq, jnp.asarray(x), interpret=True, **BLOCKS))
    qp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq))
    got = dp.apply_didbl_int8(qp, torch.from_numpy(x), **BLOCKS)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 48, 56, 3)
    d = np.abs(got.numpy() - want)
    print(f"apply_didbl_int8: mean |diff| {d.mean():.3g}, max {d.max():.3g}")
    assert d.mean() <= 5e-4 and d.max() <= 1e-2


def test_subpixel_head_not_ported(narrow):
    """The subpixel head's int8 is ``--forward int8`` (tests/test_torch_zoo_int8.py);
    the per-tensor int8 kernels of ``pallas_int8`` run the TF1 head only, and
    the engine refuses them on a subpixel model."""
    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
    from image_enhance_keras_tpu_torch.models.zoo import ModelSpec

    mod = DifvdsrDouble(features=16, upsampler="subpixel", **BLOCKS)
    spec = ModelSpec("didbl_subpixel", None, 4, False, "narrow", None)
    with pytest.raises(ValueError, match="subpixel"):
        SuperResolver(model="didbl_subpixel", module_and_spec=(mod, spec), forward="pallas_int8", device="cpu")
