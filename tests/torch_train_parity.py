"""Shared set-up of the train-step parity tests (tests/test_torch_train_step.py, test_torch_train_zoo.py).

Narrow zoo models with flax's init carried into the port's modules, seeded
uint8 batches, both packages' optimizers built as their Trainers build
them, and the comparison of both packages' states after each step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.models.difv4 import Difvdsr4 as FlaxDifv4
from image_enhance_keras_tpu.models.difvdsr import Difvdsr as FlaxDifvdsr
from image_enhance_keras_tpu.train import trainer as jt
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.difv4 import Difvdsr4
from image_enhance_keras_tpu_torch.models.difvdsr import Difvdsr
from image_enhance_keras_tpu_torch.models.weights import flatten_params, load_params
from image_enhance_keras_tpu_torch.train import trainer as pt

LOSS_RTOL, GRAD_REL, PARAM_ATOL = 1e-5, 1e-4, 1e-6
#: gradients below this on every step put an element in Adam's eps-dominated region
G_FLOOR = 1e-6
BF16_LOSS_RTOL, BF16_GAP, BF16_PARAM_MEAN = 2.0 ** -8, 2.0, 1e-2

#: name -> (flax class, port class, narrow config, train scale, pre-upscaled input, HR patch)
MODELS = {
    "didbl": (FlaxDidbl, DifvdsrDouble, dict(features=8, n_body53=2, n_light=1, n_tail53=1), 4, False, 24),
    "didbl_subpixel": (FlaxDidbl, DifvdsrDouble,
                       dict(features=8, n_body53=1, n_light=1, n_tail53=1, upsampler="subpixel"), 4, False, 16),
    "difvdsr": (FlaxDifvdsr, Difvdsr, dict(features=8, n_blocks=2), 4, True, 16),
    "difv4": (FlaxDifv4, Difvdsr4, dict(features=8, n_head=1, n_mid=1, n_tail=1), 4, False, 16),
    "difv4_x2": (FlaxDifv4, Difvdsr4, dict(features=8, n_head=1, n_mid=1, n_tail=1, scale=2), 2, False, 16),
}


def _init(name, seed=0):
    fcls, _, cfg, scale, pre_up, hr = MODELS[name]
    module = fcls(**cfg)
    side = hr if pre_up else hr // scale
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, side, side, 3)))["params"]
    return module, jax.tree_util.tree_map(np.asarray, params)


def _batches(name, n, batch=2, seed=3):
    hr = MODELS[name][5]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (batch, hr, hr, 3), dtype=np.uint8) for _ in range(n)]


def _jax_tx(module, lr, clip_norm, cosine_steps):
    sched = optax.cosine_decay_schedule(lr, decay_steps=cosine_steps, alpha=0.05) if cosine_steps else lr
    tx = optax.adam(sched, b1=0.9)
    if clip_norm:
        tx = optax.chain(optax.clip_by_global_norm(clip_norm), tx)
    return jt.mask_frozen(tx, module)


def _port_state(name, params, lr, clip_norm, cosine_steps, ema_decay, dtype=None):
    _, pcls, cfg, *_ = MODELS[name]
    module = pcls(dtype=dtype, **cfg)
    load_params(module, params)
    sched = pt.cosine_decay_schedule(lr, cosine_steps, alpha=0.05) if cosine_steps else lr
    opt = pt.Adam(pt.mask_frozen(module), sched, b1=0.9, clip_norm=clip_norm)
    ema = {k: v.detach().clone() for k, v in flatten_params(pt.TrainState(module, opt).params()).items()}
    return pt.TrainState(module, opt, 0, ema if ema_decay else None)


def _jax_grad_fn(module, scale, blur, pre_up, loss):
    """(params, hr_u8) -> the gradient of JAX's step loss, jitted."""
    objective = jt.pixel_loss_fn(loss)

    def f(p, hr):
        lr_x = jt.degrade_batch_on_device(hr, scale=scale, blur_sigma=blur)
        if pre_up:
            from image_enhance_keras_tpu.ops.resize import resize_bicubic_pil

            lr_x = resize_bicubic_pil(lr_x, (lr_x.shape[-3] * scale, lr_x.shape[-2] * scale))
        return objective(module.apply({"params": p}, lr_x), hr.astype(jnp.float32) / 255.0)

    return jax.jit(jax.grad(f))


def _run(name, loss="mse", clip_norm=None, cosine_steps=0, ema_decay=0.0, blur=0.5, n_steps=3, lr=1e-4,
         dtype=None):
    """Both packages' states after each of ``n_steps`` steps on the same batches."""
    _, _, cfg, scale, pre_up, _ = MODELS[name]
    module, params = _init(name)
    if dtype is not None:
        module = MODELS[name][0](dtype=jnp.bfloat16, **cfg)
    tx = _jax_tx(module, lr, clip_norm, cosine_steps)
    jstep = jax.jit(jt.make_train_step(module, tx, scale, blur, pre_up, ema_decay=ema_decay, loss=loss))
    js = jt.TrainState(params, tx.init(params), 0, jax.tree_util.tree_map(jnp.asarray, params) if ema_decay else None)
    ps = _port_state(name, params, lr, clip_norm, cosine_steps, ema_decay, dtype="bfloat16" if dtype else None)
    pstep = pt.make_train_step(scale, blur, pre_up, ema_decay=ema_decay, loss=loss)
    out = []
    grad_fn = _jax_grad_fn(module, scale, blur, pre_up, loss)
    gmax = None
    for i, batch in enumerate(_batches(name, n_steps)):
        jg = flatten_params(jax.tree_util.tree_map(np.asarray, grad_fn(js.params, jnp.asarray(batch))))
        gmax = {k: np.abs(g) if gmax is None else np.maximum(gmax[k], np.abs(g)) for k, g in jg.items()}
        js, jm = jstep(js, jnp.asarray(batch))
        ps, pm = pstep(ps, torch.from_numpy(batch))
        grads = None
        if i == 0:
            grads = (jg, {k: p.grad.numpy().copy() for k, p in ps.opt.params.items()})
        out.append(dict(
            gmax=dict(gmax), loss=(float(jm["loss"]), float(pm["loss"])), psnr=(float(jm["psnr"]), float(pm["psnr"])),
            params=(flatten_params(jax.tree_util.tree_map(np.asarray, js.params)),
                    {k: v.numpy().copy() for k, v in ps.params().items()}),
            ema=None if not ema_decay else (flatten_params(jax.tree_util.tree_map(np.asarray, js.ema)),
                                            {k: v.numpy().copy() for k, v in ps.ema.items()}),
            grads=grads, step=(int(js.step), ps.step),
        ))
    return params, out


def _check_f32(params, out, frozen=()):
    for i, r in enumerate(out):
        (jl, pl), (jp, pp) = r["loss"], r["psnr"]
        assert abs(pl - jl) <= LOSS_RTOL * abs(jl), (i, pl, jl)
        assert abs(pp - jp) <= LOSS_RTOL * abs(jp), (i, pp, jp)
        assert r["step"] == (i + 1, i + 1)
        jpar, ppar = r["params"]
        assert set(jpar) == set(ppar)
        for k in jpar:
            floor = r["gmax"][k] < G_FLOOR
            d = np.abs(ppar[k] - jpar[k])
            assert d[~floor].max(initial=0.0) <= PARAM_ATOL, (f"step {i + 1}", k, d[~floor].max())
            assert d[floor].max(initial=0.0) <= (i + 1) * 1e-4, (f"step {i + 1}", k, d[floor].max())
            if k.split("/")[0] in frozen:  # exactly zero update in both
                np.testing.assert_array_equal(ppar[k], flatten_params(params)[k])
                np.testing.assert_array_equal(jpar[k], flatten_params(params)[k])
        if r["ema"] is not None:
            for k, v in r["ema"][0].items():
                d = np.abs(r["ema"][1][k] - v)[r["gmax"][k] >= G_FLOOR]
                assert d.max(initial=0.0) <= PARAM_ATOL, ("ema", k, d.max())
        if r["grads"] is not None:
            jg, pg = r["grads"]
            assert set(pg) == {k for k in jg if k.split("/")[0] not in frozen}
            for k, g in pg.items():
                scale = max(float(np.abs(jg[k]).max()), 1e-30)
                assert np.abs(g - jg[k]).max() <= GRAD_REL * scale, (k, np.abs(g - jg[k]).max(), scale)
