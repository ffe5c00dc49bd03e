"""One train step of the port against the JAX package's jitted step on the CPU.

Narrow models (didbl 8 features, 2+1+1 blocks; difvdsr 8 features, 2
blocks; difv4 8 features, 1+1+1 blocks) start from flax's init, carried
into the port's modules, and take the same seeded uint8 batch (HR 16-24).
Each case builds the optimizer as both Trainers do: ``optax.adam(lr, b1)``
(or the cosine schedule), behind ``clip_by_global_norm`` and the frozen
mask where set, against the port's ``Adam`` over ``mask_frozen``.
Tolerances: the loss within rtol 1e-5; each gradient leaf within 1e-4 of
the leaf's largest magnitude (float32 convolutions summed in other
orders); params and the EMA after 1 and 3 steps within 1e-6 at lr 1e-4;
frozen leaves bit-unchanged.  Adam divides by sqrt(nu) + 1e-8, so where
every step's gradient is below G_FLOOR (1e-6) the update amplifies the
gradients' rounding gap (by up to lr / 1e-8 at zero): there the params are
held to the update's own size, n_steps * lr.  Fed JAX's own gradients,
the port's Adam gives optax's params within 1e-7 everywhere, near-zero
gradients included.  The frozen mask, the rest of the zoo and bf16 are in
tests/test_torch_train_zoo.py, the shared set-up in tests/torch_train_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_enhance_keras_tpu.train import trainer as jt
from image_enhance_keras_tpu_torch.models.weights import flatten_params
from image_enhance_keras_tpu_torch.train import trainer as pt
from tests.torch_train_parity import MODELS, _batches, _check_f32, _init, _jax_grad_fn, _jax_tx, _port_state, _run
@pytest.mark.parametrize("loss", ["mse", "charbonnier", "l1"])
def test_didbl_step_matches_jax(loss):
    params, out = _run("didbl", loss=loss)
    _check_f32(params, out)
    assert out[-1]["loss"][1] != out[0]["loss"][1]


def test_clip_cosine_ema_step_matches_jax():
    # clip_norm far below the gradient norm, so every step rescales
    params, out = _run("didbl", clip_norm=1e-3, cosine_steps=4, ema_decay=0.9)
    _check_f32(params, out)


@pytest.mark.parametrize("loss", ["mse", "charbonnier", "l1"])
def test_pixel_loss_fn_matches_jax(loss):
    rng = np.random.default_rng(7)
    pred = rng.standard_normal((2, 24, 24, 3)).astype(np.float32) * 0.3 + 0.5
    y = rng.random((2, 24, 24, 3), dtype=np.float32)
    want = float(jt.pixel_loss_fn(loss, 1e-3)(jnp.asarray(pred), jnp.asarray(y)))
    got = float(pt.pixel_loss_fn(loss, 1e-3)(torch.from_numpy(pred), torch.from_numpy(y)))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    with pytest.raises(ValueError, match="unknown loss"):
        pt.pixel_loss_fn("huber")


def test_cosine_schedule_matches_optax():
    want = optax.cosine_decay_schedule(3e-4, decay_steps=7, alpha=0.05)
    got = pt.cosine_decay_schedule(3e-4, 7, alpha=0.05)
    for c in range(10):
        np.testing.assert_allclose(got(c), float(want(jnp.asarray(c, jnp.int32))), rtol=2e-7)
    assert got(0) == pytest.approx(3e-4, rel=1e-7)  # step 0 trains at lr


@pytest.mark.parametrize("case", [dict(), dict(clip_norm=1e-3, cosine_steps=4), dict(clip_norm=1e9, name="difvdsr")])
def test_adam_on_jax_gradients_matches_optax(case):
    """The update alone: JAX's gradients of 3 steps through optax and through
    the port's Adam (clip, schedule and frozen mask as set) give the same
    params within 1e-7, the near-zero gradients included."""
    name = case.get("name", "didbl")
    module, params = _init(name)
    _, _, _, scale, pre_up, _ = MODELS[name]
    tx = _jax_tx(module, 1e-4, case.get("clip_norm"), case.get("cosine_steps", 0))
    ps = _port_state(name, params, 1e-4, case.get("clip_norm"), case.get("cosine_steps", 0), 0.0)
    grad_fn = _jax_grad_fn(module, scale, 0.5, pre_up, "mse")
    jparams, opt_state = params, tx.init(params)
    rng = np.random.default_rng(1)
    for batch in _batches(name, 3):
        # a few exact zeros and values near Adam's eps among the gradients
        g = jax.tree_util.tree_map(
            lambda a: np.where(rng.random(a.shape) < 0.05, np.float32(0.0), np.asarray(a) *
                               np.where(rng.random(a.shape) < 0.05, np.float32(1e-6), np.float32(1.0))),
            grad_fn(jparams, jnp.asarray(batch)))
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = jax.tree_util.tree_map(np.asarray, optax.apply_updates(jparams, updates))
        flat = flatten_params(g)
        for k, p in ps.opt.params.items():
            p.grad = torch.from_numpy(np.array(flat[k], np.float32))
        ps.opt.step()
    want = flatten_params(jparams)
    for k, v in ps.params().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-7, err_msg=k)
    assert ps.opt.count == 3
