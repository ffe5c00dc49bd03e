"""The port's scale-out (``parallel/``) against its single-device engine and JAX's on the CPU.

One case per case of tests/test_parallel.py.  The narrow didbl (8 features,
1 + 1 + n_tail53 blocks) with flax's init carried into the port, JAX's
geometry (tiles of 48 at step 32, chunks of 8, split stripes of 16) and
seeded images of at most 100 px.  The port's ``ShardedResolver`` runs on a
mesh of CPU entries (``make_mesh(n, devices=["cpu"] * n)``), JAX's on the
conftest's 8 virtual devices.  Each case holds:

  * the port's sharded output against the port's single-device output, at
    JAX's bounds: byte-equal for the batch-sharded modes (patch, video,
    patch-average), within one uint8 level for the banded ones (fast,
    frame, split, split2d, int8 fast and split2d, the split2d remainder);
  * the port's sharded output against JAX's ``ShardedResolver``, within the
    engine tests' bounds: float32 forwards at most 1 level on at most 0.1%
    of the values (tests/test_torch_engine.py), ``--forward int8`` at most
    3 levels (the jitted JAX engine drops the bf16 accumulator's rounding,
    tests/test_torch_int8_xla.py), both on JAX's quantized tree.

Besides: ``int8_dynamic_tail`` in fast mode on 2 and 4 bands is byte-equal
to the single-device engine (the per-sample abs-max reduced over the
bands), and one data-parallel train step on 4 CPU entries equals the
single-device step and JAX's ``Trainer(mesh=make_mesh(4))`` step (loss
within 1e-5, params within 1e-6 where the gradient is not below 1e-6,
tests/torch_train_parity.py); a batch the mesh does not divide is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.models import init_params as jax_init
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.models.zoo import ModelSpec as JaxSpec
from image_enhance_keras_tpu.parallel import ShardedResolver as JaxSharded
from image_enhance_keras_tpu.parallel import make_mesh as jax_make_mesh
from image_enhance_keras_tpu_torch.engine import SuperResolver
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.weights import params_from_numpy
from image_enhance_keras_tpu_torch.models.zoo import ModelSpec
from image_enhance_keras_tpu_torch.parallel import ShardedResolver, make_mesh, shard_batch

MAX_DIFF, MAX_FRAC = 1, 1e-3
INT8_MAX_DIFF = 3


def _cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _jax_build(cls, module, params, **attrs):
    """A JAX engine assembled as tests/test_parallel.py assembles it."""
    r = cls.__new__(cls)
    r.model_name, r.module = "tiny", module
    r.spec = JaxSpec("tiny", lambda **k: module, 4, False, "tiny", "w")
    r.patch, r.step, r.crop, r.scalemulti = 48, 32, 8, 4
    r.mode, r.fast_max_pixels, r.split_tile = "patch", 1 << 20, 16
    r.forward_mode, r._dtype, r._jitted, r._jitted_fast = "xla", None, {}, {}
    r.params = params
    for k, v in attrs.items():
        setattr(r, k, v)
    return r


def _port_build(cls, pn, tail53, n_devices=8, **attrs):
    module = DifvdsrDouble(features=8, n_body53=1, n_light=1, n_tail53=tail53)
    spec = ModelSpec("tiny", lambda **k: module, 4, False, "tiny", None)
    kw = dict(mesh=_cpu_mesh(n_devices)) if cls is ShardedResolver else {}
    r = cls(params=pn, module_and_spec=(module, spec), device="cpu", patch=48, step=32, crop=8,
            forward=attrs.pop("forward_mode", "xla"), **kw)
    r.split_tile = 16
    for k, v in attrs.items():
        setattr(r, k, v)
    return r


@pytest.fixture(scope="module")
def models():
    """Narrow flax modules and params (n_tail53 0 and 1), and JAX's int8 tree of the second."""
    from image_enhance_keras_tpu.models import didbl_pallas as jax_dp

    out = {}
    for tail53 in (0, 1):
        module = FlaxDidbl(features=8, n_body53=1, n_light=1, n_tail53=tail53)
        params = jax_init(module, jax.random.PRNGKey(0), input_hw=(16, 16))
        out[tail53] = (module, params, jax.tree_util.tree_map(np.asarray, params))
    module, params, _ = out[1]
    calib = np.random.default_rng(9).random((2, 20, 20, 3)).astype(np.float32)
    with jax.disable_jit():
        jq = jax_dp.quantize_didbl_params(params, n_body53=1, n_light=1, n_tail53=1, calib_x=jnp.asarray(calib))
    out["int8"] = (jq, jax.tree_util.tree_map(np.asarray, jq))
    return out


def _engines(models, tail53=1, n_devices=8, **attrs):
    """(port single, port sharded, JAX sharded) with the same weights and attributes."""
    module, params, pn = models[tail53]
    attrs = {"tile_chunk": 8, **attrs}
    port = [_port_build(c, pn, tail53, n_devices, **dict(attrs)) for c in (SuperResolver, ShardedResolver)]
    jr = _jax_build(JaxSharded, module, params, **attrs)
    jr.mesh, jr.n_devices = jax_make_mesh(8), 8
    if attrs.get("forward_mode") == "int8":
        jq, qn = models["int8"]
        jr._qparams = jq
        for r in port:
            r._qparams = r._place_weights(params_from_numpy(qn))
    return (*port, jr)


def _check(models, run, exact, tail53=1, jax_bound=MAX_DIFF, n_devices=8, **attrs):
    single, sharded, jr = _engines(models, tail53, n_devices, **attrs)
    a, b = run(sharded).astype(np.int16), run(single).astype(np.int16)
    assert a.shape == b.shape
    d = np.abs(a - b)
    print(f"sharded vs single: max {d.max()}, {(d > 0).sum()} differing values")
    assert d.max() == 0 if exact else d.max() <= 1
    j = np.abs(a - np.asarray(run(jr)).astype(np.int16))
    print(f"port sharded vs JAX sharded: max {j.max()}, differing fraction {(j > 0).mean():.3g}")
    assert j.max() <= jax_bound
    if jax_bound == MAX_DIFF:
        assert (j > 0).mean() <= MAX_FRAC
    return sharded, a


def _img(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_mesh_has_8_entries():
    mesh = make_mesh(8, devices=["cpu"] * 8)
    assert mesh.devices.size == 8 and mesh.axis_names == ("data",)
    assert mesh.local_devices() == [torch.device("cpu")] * 8
    assert len(jax.devices()) == 8 and jax_make_mesh().devices.size == 8


def test_shard_batch_layout():
    shards = shard_batch(torch.zeros((16, 4, 4, 3)), _cpu_mesh(8))
    assert {tuple(s.shape) for s in shards} == {(2, 4, 4, 3)} and len(shards) == 8
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(torch.zeros((6, 4, 4, 3)), _cpu_mesh(4))


def test_maybe_init_distributed_noop_without_env(monkeypatch):
    from image_enhance_keras_tpu_torch.parallel import maybe_init_distributed

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert maybe_init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_sharded_resolver_matches_single_device(models):
    """Tiles over 8 entries == the single-device engine, byte for byte."""
    sharded, out = _check(models, lambda r: r.upscale(_img(0, 80, 100)), exact=True, tail53=0)
    assert out.shape == (320, 400, 3)


def test_sharded_fast_mode_matches_single_device(models):
    _check(models, lambda r: r.upscale(_img(1, 64, 72)), exact=False, mode="fast")


def test_sharded_split_mode_matches_single_device(models):
    _check(models, lambda r: r.upscale(_img(2, 48, 40)), exact=False, mode="split")


def test_sharded_video_matches_single_device(models):
    vid = np.random.default_rng(3).integers(0, 256, (5, 24, 24, 3), dtype=np.uint8)
    _check(models, lambda r: r.upscale_video(vid), exact=True)


def test_sharded_frame_matches_single_device(models):
    _check(models, lambda r: r.upscale_frame(_img(4, 32, 40)), exact=False)


def test_sharded_average_matches_single_device(models):
    _check(models, lambda r: r.upscale_patch_average(_img(5, 40, 40), patch=16, step=8), exact=True)


def test_sharded_int8_fast_matches_single_device(models):
    _, out = _check(models, lambda r: r.upscale(_img(2, 48, 56)), exact=False, jax_bound=INT8_MAX_DIFF,
                    mode="fast", forward_mode="int8")
    assert out.shape == (192, 224, 3)


def test_sharded_split2d_matches_single_device(models):
    _check(models, lambda r: r.upscale(_img(6, 48, 40)), exact=False, mode="split", split_tile_w=16)


def test_sharded_int8_split2d_matches_single_device(models):
    _, out = _check(models, lambda r: r.upscale(_img(7, 48, 56)), exact=False, jax_bound=INT8_MAX_DIFF,
                    mode="split", split_tile_w=16, forward_mode="int8")
    assert out.shape == (192, 224, 3)


def test_sharded_split2d_remainder_chunking(models):
    """A tile count that is not a multiple of the device count pads only the remainder."""
    _check(models, lambda r: r.upscale(_img(8, 40, 24)), exact=False, mode="split", split_tile=8,
           split_tile_w=8, split2d_chunk=1)


def test_sharded_int8_split2d_s8_emit_matches_wide(models, monkeypatch):
    img = _img(9, 48, 56)
    out = {}
    for emit in ("wide", "s8"):
        monkeypatch.setenv("IEK_INT8_EMIT", emit)
        _, sharded, _ = _engines(models, mode="split", split_tile_w=16, forward_mode="int8")
        out[emit] = sharded.upscale(img)
    np.testing.assert_array_equal(out["s8"], out["wide"])


def test_make_mesh_rejects_zero_devices():
    for n in (0, -1):
        with pytest.raises(ValueError, match=f"requested {n} devices"):
            make_mesh(n, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        make_mesh(3, devices=["cpu"] * 2)


@pytest.mark.parametrize("n_bands", [2, 4])
def test_int8_dynamic_tail_fast_bands_byte_equal(models, n_bands, monkeypatch):
    """The HR tail quantized per sample: every band quantizes with the frame's
    abs-max, so the banded output equals the single-device one byte for byte
    (a band's own abs-max would be another result)."""
    from image_enhance_keras_tpu_torch.parallel import bands

    single, sharded, _ = _engines(models, n_devices=n_bands, mode="fast", forward_mode="int8",
                                  int8_dynamic_tail=True)
    img = _img(10, 48, 56)
    want = single.upscale(img)
    np.testing.assert_array_equal(sharded.upscale(img), want)
    # without the reduction (each band its own abs-max) the output moves
    monkeypatch.setattr(bands, "_drive", _own_scales)
    assert not np.array_equal(sharded.upscale(img), want)


def _own_scales(gens, devices):
    """``bands._drive`` without the reduction: each band sent its own abs-max."""
    outs = [None] * len(gens)
    vals = [next(g) for g in gens]
    while any(o is None for o in outs):
        for i, g in enumerate(gens):
            try:
                vals[i] = g.send(vals[i])
            except StopIteration as stop:
                outs[i] = stop.value
    return outs


# -- the data-parallel train step -------------------------------------------------

def _trainers(tmp_path, mesh_n, batch):
    from image_enhance_keras_tpu.train.trainer import Trainer as JaxTrainer
    from image_enhance_keras_tpu.utils.config import Config as JaxConfig
    from image_enhance_keras_tpu_torch.train.trainer import Trainer
    from image_enhance_keras_tpu_torch.utils.config import Config

    images = [np.random.default_rng(s).integers(0, 256, (40, 40, 3), dtype=np.uint8) for s in range(3)]
    kw = dict(model="didbl", model_kwargs=dict(features=8, n_body53=1, n_light=1, n_tail53=1), batch_size=batch,
              lr_patch=6, steps_per_epoch=1, epochs=1, monitor="val_psnr", clip_norm=0.5, ema_decay=0.5)
    jt = JaxTrainer(JaxConfig(checkpoint_dir=str(tmp_path / "jax"), **kw), images, mesh=jax_make_mesh(mesh_n))
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    single = Trainer(Config(checkpoint_dir=str(tmp_path / "one"), **kw), images, params=params, device="cpu")
    sharded = Trainer(Config(checkpoint_dir=str(tmp_path / "dp"), **kw), images, params=params,
                      mesh=_cpu_mesh(mesh_n))
    return jt, single, sharded


def test_dp_train_step_matches_single_device_and_jax(tmp_path):
    from image_enhance_keras_tpu_torch.models.weights import flatten_params
    from tests.torch_train_parity import G_FLOOR, LOSS_RTOL, PARAM_ATOL

    jt, single, sharded = _trainers(tmp_path, 4, 4)
    batch = np.random.default_rng(4).integers(0, 256, (4, 24, 24, 3), dtype=np.uint8)
    js, jm = jt.train_step(jt.state, jt._global_batch(batch))
    _, m1 = single.train_step(single.state, single._batch(batch))
    grad = {k: p.grad.numpy() for k, p in single.state.opt.params.items()}
    _, m4 = sharded.train_step(sharded.state, sharded._batch(batch))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, js.params))
    for ref_loss, ref_params, name in ((float(m1["loss"]), single.state.params(), "single"),
                                       (float(jm["loss"]), want, "JAX")):
        assert abs(float(m4["loss"]) - ref_loss) <= LOSS_RTOL * abs(ref_loss), name
        for k, v in sharded.state.params().items():
            d = np.abs(v.numpy() - np.asarray(ref_params[k]))
            floor = np.abs(grad.get(k, np.zeros_like(d))) < G_FLOOR
            assert d[~floor].max(initial=0.0) <= PARAM_ATOL, (name, k, d[~floor].max())
            assert d[floor].max(initial=0.0) <= 1e-4, (name, k)  # the update's size, lr
    ema = {k: v.numpy() for k, v in sharded.state.ema.items()}
    jema = flatten_params(jax.tree_util.tree_map(np.asarray, js.ema))
    assert max(float(np.abs(ema[k] - jema[k]).max()) for k in ema) <= 1e-4


def test_dp_train_step_refuses_a_batch_the_mesh_does_not_divide(tmp_path):
    jt, _, sharded = _trainers(tmp_path, 4, 6)
    batch = np.zeros((6, 24, 24, 3), dtype=np.uint8)
    with pytest.raises(ValueError, match="does not divide over the mesh's 4 devices"):
        sharded.train_step(sharded.state, sharded._batch(batch))
    with pytest.raises(ValueError):
        jt.train_step(jt.state, jt._global_batch(batch))


# -- the banded stages of every forward ------------------------------------------------

ZOO_NARROW = {
    "didbl": dict(features=8, n_body53=2, n_light=1, n_tail53=1),
    "didbl_subpixel": dict(features=8, n_body53=1, n_light=1, n_tail53=1),
    "difv4": dict(features=8, n_head=1, n_mid=2, n_tail=1),
    "difv4_x2": dict(features=8, n_head=1, n_mid=1, n_tail=1),
    "difvdsr": dict(features=8, n_blocks=2),
}


@pytest.mark.parametrize("model,forward,mode,opts", [
    ("didbl", "xla", "fast", dict(dtype="bfloat16")),
    ("didbl", "xla", "fast", dict(mixed=True)),
    ("didbl", "xla", "split", dict(mixed="tail")),
    ("didbl", "pallas", "fast", {}),
    ("didbl", "pallas_chain", "fast", dict(dtype="bfloat16")),
    ("didbl", "pallas_int8", "split", {}),
    ("didbl_subpixel", "xla", "split", {}),
    ("didbl_subpixel", "int8", "fast", {}),
    ("didbl_subpixel", "int8", "split", dict(int8_dynamic_tail=True)),
    ("difv4", "xla", "split", {}),
    ("difv4", "int8", "fast", {}),
    ("difv4_x2", "xla", "fast", dict(dtype="bfloat16")),
    ("difvdsr", "xla", "fast", {}),
    ("difvdsr", "int8", "fast", {}),
])
def test_banded_stages_match_every_forward(model, forward, mode, opts):
    """Every model and forward's stages (``parallel/bands.py``) over 3 bands
    of rows (split: the tail's stripes over 3 bands of columns) against the
    single-device engine, within JAX's bound for the banded modes (one
    level; a library conv of another extent may sum in another order: the
    bf16 3x3 entry conv of difvdsr's int8 forward moves 13 values here)."""
    attrs = {k: opts[k] for k in ("int8_dynamic_tail",) if k in opts}
    kw = dict(model=model, model_kwargs=ZOO_NARROW[model], forward=forward, mode=mode, split_tile=8, device="cpu",
              **{k: v for k, v in opts.items() if k not in attrs})
    single = SuperResolver(**kw)
    sharded = ShardedResolver(**kw, mesh=_cpu_mesh(3))
    for r in (single, sharded):
        for k, v in attrs.items():
            setattr(r, k, v)
    if forward.endswith("int8"):
        # calibrated once, on a small seeded crop (the calibration is not under test here)
        single._calib_x = torch.from_numpy(np.random.default_rng(12).random((1, 16, 16, 3)).astype(np.float32))
        if single.spec.pre_upscaled_input:
            single._calib_x = torch.nn.functional.interpolate(single._calib_x.permute(0, 3, 1, 2), scale_factor=4) \
                .permute(0, 2, 3, 1).contiguous()
        sharded._qparams = sharded._place_weights(single._fwd_params())
    img = _img(11, 20, 24)
    d = np.abs(sharded.upscale(img).astype(np.int16) - single.upscale(img).astype(np.int16))
    assert d.max() <= MAX_DIFF and (d > 0).mean() <= MAX_FRAC, (d.max(), (d > 0).sum())
