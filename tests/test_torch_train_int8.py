"""Internal learning under ``--forward int8`` in the port against the JAX package on the CPU.

The set-up of tests/test_torch_train_engine.py (a narrow didbl with flax's
init, a seeded 32x32 image, 3 adaptation steps).  The image is served on
int8 scales calibrated on the adapted params, the base scales return after
the call, and the output is within the int8 bound of tests/test_torch_engine.py
(3 levels on under 5% of the values) of JAX's engine run op by op.
"""

import jax
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.weights import params_of_module
from tests.test_torch_train_engine import INT8_MAX_DIFF, INT8_MAX_FRAC, NARROW, STEPS, _engines, _gap, _image, narrow  # noqa: F401


@pytest.mark.parametrize("mode", ["fast", "patch"])
def test_internal_learn_int8_recalibrates_and_restores(narrow, mode):
    """The int8 scales come from the adapted params (the output equals a
    fresh engine's on them) and the base scales return; in fast mode the
    output is within the int8 bound of JAX's engine run op by op."""
    jr, pr = _engines(narrow, forward="int8", mode=mode)
    img = _image()
    calib = port_engine.SuperResolver(params=narrow[1], module_and_spec=(
        DifvdsrDouble(**NARROW), port_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)),
        patch=24, step=16, device="cpu", forward="int8", mode=mode)
    base_out = calib.upscale(img)
    q0 = pr._fwd_params()
    got = pr.upscale(img)
    assert pr._qparams is q0
    with torch.inference_mode():
        adapted = pr._internal_adapt(img, STEPS)
    fresh = port_engine.SuperResolver(params=params_of_module(adapted), module_and_spec=(
        DifvdsrDouble(**NARROW), port_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)),
        patch=24, step=16, device="cpu", forward="int8", mode=mode)
    np.testing.assert_array_equal(got, fresh.upscale(img))
    assert not np.array_equal(got, base_out)
    if mode == "fast":
        # JAX's upscale with internal learning, its adaptation jitted and its
        # int8 serving run op by op (as the port runs it)
        jr.params, jr._qparams = jr._place_weights(jr._internal_adapt(img, STEPS)), None
        with jax.disable_jit():
            want = np.asarray(jr._upscale_post(img))
        dmax, frac = _gap(got, want)
        assert dmax <= INT8_MAX_DIFF and frac < INT8_MAX_FRAC, (dmax, frac)
    pr.internal_learn = 0
    np.testing.assert_array_equal(pr.upscale(img), base_out)
