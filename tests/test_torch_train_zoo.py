"""One train step of the port against JAX's on the CPU: the frozen mask, the rest of the zoo and bf16.

The set-up and the float32 bounds are tests/test_torch_train_step.py's
(``tests/torch_train_parity.py``).  difvdsr's frozen entry conv, with the
global-norm clip, gets no gradient, no Adam state and exactly zero update
in both packages; difv4 (its two x2s), difv4_x2 and didbl_subpixel meet
the float32 bounds.  The bf16 profile is held to the bf16 bounds of
tests/test_torch_mixed.py and tests/test_torch_bf16.py: the loss within
one bf16 ulp (2^-8); each gradient leaf's largest and mean gap to JAX's
within twice what bf16 itself moves JAX's gradient from float32's; the
params' largest gap within two updates' size per step (2 lr: a gradient's
sign may flip) and their mean gap within 1% of lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from image_enhance_keras_tpu_torch.models.weights import flatten_params
from tests.torch_train_parity import (BF16_GAP, BF16_LOSS_RTOL, BF16_PARAM_MEAN, _batches, _check_f32, _init, _jax_grad_fn,
                                      _port_state, _run)


def test_difvdsr_frozen_mask_with_clip_matches_jax():
    """The frozen entry conv gets no gradient, no Adam state and exactly zero
    update, and the clip's global norm leaves it out, in both packages."""
    params, out = _run("difvdsr", clip_norm=1e-3, ema_decay=0.5)
    _check_f32(params, out, frozen=("level1",))
    state = _port_state("difvdsr", params, 1e-4, 1e-3, 0, 0.0)
    assert not any(k.startswith("level1/") for k in state.opt.mu)
    assert not any(p.requires_grad for p in state.module.level1.parameters())


@pytest.mark.parametrize("name", ["difv4", "difv4_x2", "didbl_subpixel"])
def test_zoo_step_matches_jax(name):
    params, out = _run(name, n_steps=2)
    _check_f32(params, out)


def test_bf16_step_matches_jax():
    lr = 1e-4
    params, out = _run("didbl", n_steps=2, dtype="bfloat16", lr=lr)
    for i, r in enumerate(out):
        jl, pl = r["loss"]
        assert abs(pl - jl) <= BF16_LOSS_RTOL * abs(jl), (pl, jl)
        d = np.concatenate([np.abs(r["params"][1][k] - v).ravel() for k, v in r["params"][0].items()])
        assert d.max() <= 2 * (i + 1) * lr and d.mean() <= BF16_PARAM_MEAN * lr, (d.max(), d.mean())
    # the yardstick: what bf16 itself moves JAX's gradient, against float32
    module, _ = _init("didbl")
    g32 = flatten_params(jax.tree_util.tree_map(np.asarray, _jax_grad_fn(module, 4, 0.5, False, "mse")(
        params, jnp.asarray(_batches("didbl", 1)[0]))))
    jg, pg = out[0]["grads"]
    for k, g in pg.items():
        d, yard = np.abs(g - jg[k]), np.abs(jg[k] - g32[k])
        assert d.max() <= BF16_GAP * yard.max() and d.mean() <= BF16_GAP * yard.mean(), (k, d.max(), yard.max())
