"""The rest of the zoo (didbl_subpixel, difv4, difv4_x2, difvdsr) in the port against the JAX package on the CPU.

Narrow models (features 16, one or two blocks a tower) with flax's init
carried into the port's modules; inputs seeded with numpy.  Module
forwards in float32 agree within 3e-5, in bf16 within the uint8 bound of
tests/test_torch_bf16.py, in the mixed profile within the bound of
tests/test_torch_mixed.py.  The engines' uint8 outputs agree within 1
level on 0.1% of the values (float32 forwards summed in other orders,
tests/test_torch_engine.py), and the port's split mode equals its fast
mode byte for byte.  difvdsr runs on a PIL-bicubic x4 of its input in
every mode; its calibration inputs equal JAX's.  The committed demo
checkpoints load into the full-width modules and forward as JAX's do.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu.models.zoo_int8 as jax_zoo_int8
import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu.cli.main_dirpath import main as jax_main
from image_enhance_keras_tpu.cli.scorpath import main as jax_scorpath
from image_enhance_keras_tpu.eval import evaluate as jax_evaluate
from image_enhance_keras_tpu.models import didbl_pallas as jax_dp
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.models.difv4 import Difvdsr4 as FlaxDifv4
from image_enhance_keras_tpu.models.difvdsr import Difvdsr as FlaxDifvdsr
from image_enhance_keras_tpu_torch.cli.common import resolve_cli_weights
from image_enhance_keras_tpu_torch.cli.main_dirpath import main as port_main
from image_enhance_keras_tpu_torch.cli.scorpath import main as port_scorpath
from image_enhance_keras_tpu_torch.data.io import _bmp_write, imread
from image_enhance_keras_tpu_torch.eval import evaluate
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.difv4 import Difvdsr4
from image_enhance_keras_tpu_torch.models.difvdsr import Difvdsr
from image_enhance_keras_tpu_torch.models.weights import flatten_params, load_params
from image_enhance_keras_tpu_torch.train.checkpoints import load_params_npz

ATOL = 3e-5
MAX_DIFF, MAX_FRAC = 1, 1e-3
#: bf16 module forwards: uint8 within 1 level on under U8_FRAC, mean |d| in levels (test_torch_bf16)
U8_FRAC, MEAN_LEVELS = 0.03, 0.025
#: mixed module forwards: max and mean |d| as fractions of max|ref| (test_torch_mixed)
CHAIN_MAX, CHAIN_MEAN = 2.0 ** -6, 1e-4

#: name -> (narrow config, flax class, port class, net scale, pre-upscaled input); also
#: tests/test_torch_zoo_int8.py's
ZOO = {
    "didbl_subpixel": (dict(features=16, n_body53=1, n_light=1, n_tail53=1, upsampler="subpixel"),
                       FlaxDidbl, DifvdsrDouble, 4, False),
    "difv4": (dict(features=16, n_head=1, n_mid=2, n_tail=1), FlaxDifv4, Difvdsr4, 4, False),
    "difv4_x2": (dict(features=16, n_head=1, n_mid=2, n_tail=1, scale=2), FlaxDifv4, Difvdsr4, 2, False),
    "difvdsr": (dict(features=16, n_blocks=2), FlaxDifvdsr, Difvdsr, 1, True),
}
SPLIT_MODELS = ["didbl_subpixel", "difv4", "difv4_x2"]
GEOM = dict(patch=24, step=16)


def _assert_u8_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= MAX_DIFF and (d > 0).mean() <= MAX_FRAC, (d.max(), (d > 0).mean())


@pytest.fixture(scope="module")
def narrow():
    """name -> (flax module, flax params as numpy) and a seeded 20x28 image."""
    out = {}
    for i, (name, (cfg, fcls, _, _, _)) in enumerate(ZOO.items()):
        module = fcls(**cfg)
        params = module.init(jax.random.PRNGKey(5 + i), jnp.zeros((1, 16, 16, 3)))["params"]
        out[name] = (module, jax.tree_util.tree_map(np.asarray, params))
    img = np.random.default_rng(21).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    return out, img


def _port_module(name, pn, **kw):
    cfg, _, pcls, _, _ = ZOO[name]
    mod = pcls(**cfg, **kw)
    load_params(mod, pn)
    return mod.eval()


def _x(seed, hw=(12, 10)):
    return np.random.default_rng(seed).random((2, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_module_float32_matches_flax(narrow, name):
    module, pn = narrow[0][name]
    x = _x(1)
    want = np.asarray(module.apply({"params": pn}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_module(name, pn)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 12 * ZOO[name][3], 10 * ZOO[name][3], 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", SPLIT_MODELS)
def test_body_and_tail_match_flax(narrow, name):
    """The split decomposition: body (2x for difv4) and the declared tail method."""
    module, pn = narrow[0][name]
    mod = _port_module(name, pn)
    tail = getattr(mod, "split_tail_method", "tail")
    x = _x(2)
    hb = module.apply({"params": pn}, jnp.asarray(x), method="body")
    with torch.no_grad():
        got_h = mod.body(torch.from_numpy(x))
        got = getattr(mod, tail)(torch.from_numpy(np.array(hb)))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(hb), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(module.apply({"params": pn}, hb, method=tail)), atol=ATOL)
    assert getattr(mod, "body_upscale", 1) * getattr(mod, "tail_upscale", mod.scale) == ZOO[name][3]
    assert mod.split_halo == getattr(module, "split_halo")


@pytest.mark.parametrize("name", sorted(ZOO))
def test_module_bf16_matches_flax(narrow, name):
    cfg, fcls, _, _, _ = ZOO[name]
    _, pn = narrow[0][name]
    x = _x(3)
    want = np.asarray(fcls(**cfg, dtype=jnp.bfloat16).apply({"params": pn}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_module(name, pn, dtype="bfloat16")(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    u8 = np.abs(np.clip(np.round(got * 255), 0, 255) - np.clip(np.round(want * 255), 0, 255))
    mean = float(np.abs(got - want).mean() * 255)
    assert u8.max() <= 1 and (u8 > 0).mean() < U8_FRAC and mean <= MEAN_LEVELS, (u8.max(), (u8 > 0).mean(), mean)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_module_mixed_matches_flax(narrow, name):
    cfg, fcls, _, _, _ = ZOO[name]
    _, pn = narrow[0][name]
    x = _x(4)
    want = np.asarray(fcls(**cfg, dtype=jnp.bfloat16, mixed=True).apply({"params": pn}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_module(name, pn, dtype="bfloat16", mixed=True)(torch.from_numpy(x)).numpy()
    d, ref = np.abs(got - want), float(np.abs(want).max())
    assert d.max() <= CHAIN_MAX * ref and d.mean() <= CHAIN_MEAN * ref, (d.max(), d.mean(), ref)


def test_subpixel_mixed_tail_matches_flax(narrow):
    cfg, fcls, _, _, _ = ZOO["didbl_subpixel"]
    _, pn = narrow[0]["didbl_subpixel"]
    x = _x(5)
    want = np.asarray(fcls(**cfg, dtype=jnp.bfloat16, mixed_tail=True).apply({"params": pn}, jnp.asarray(x)))
    with torch.no_grad():
        mod = _port_module("didbl_subpixel", pn, dtype="bfloat16", mixed_tail=True)
        got = mod(torch.from_numpy(x)).numpy()
    assert mod.subpixel_conv.mixed and not mod.body53_0.conv_a1.mixed
    u8 = np.abs(np.clip(np.round(got * 255), 0, 255) - np.clip(np.round(want * 255), 0, 255))
    assert u8.max() <= 1 and (u8 > 0).mean() < U8_FRAC


@pytest.mark.parametrize("name", ["difv4", "difvdsr"])
def test_mixed_tail_is_refused_outside_didbl(name):
    """JAX's Difvdsr4 / Difvdsr take no mixed_tail: both packages raise TypeError."""
    with pytest.raises(TypeError):
        jax_zoo.get_model(name, dtype=jnp.bfloat16, mixed_tail=True)
    with pytest.raises(TypeError):
        port_zoo.get_model(name, dtype="bfloat16", mixed_tail=True)


def _resolvers(narrow, name, **kw):
    (module, pn), pre = narrow[0][name], ZOO[name][4]
    scale = ZOO[name][3]
    jspec = jax_zoo.ModelSpec(name, lambda **k: module, scale, pre, "narrow", None)
    jr = jax_engine.SuperResolver(model=name, params=jax.tree_util.tree_map(jnp.asarray, pn),
                                  module_and_spec=(module, jspec), **GEOM, **kw)
    pmod = _port_module(name, pn)
    pspec = port_zoo.ModelSpec(name, lambda **k: pmod, scale, pre, "narrow", None)
    pr = port_engine.SuperResolver(model=name, params=pn, module_and_spec=(pmod, pspec), device="cpu",
                                   **GEOM, **kw)
    return jr, pr


#: engine modes: patch, fast, split over row stripes, split over 2-D tiles
MODES = {"patch": dict(mode="patch"), "fast": dict(mode="fast"), "split": dict(mode="split", split_tile=4),
         "split2d": dict(mode="split", split_tile=8, split_tile_w=8)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(ZOO))
def test_engine_matches_jax(narrow, name, mode, caplog):
    if name == "difvdsr" and mode.startswith("split"):
        pytest.skip("difvdsr has no body/tail split: both engines fall back to patch "
                    "(test_difvdsr_split_falls_back_to_patch)")
    jr, pr = _resolvers(narrow, name, **MODES[mode])
    img = narrow[1]
    got = pr.upscale(img)
    assert got.shape == (20 * 4 if name != "difv4_x2" else 40, 28 * 4 if name != "difv4_x2" else 56, 3)
    _assert_u8_close(got, np.asarray(jr.upscale(img)))


@pytest.mark.parametrize("split", ["split", "split2d"])
@pytest.mark.parametrize("name", SPLIT_MODELS)
def test_split_equals_fast_byte_for_byte(narrow, name, split):
    _, fast = _resolvers(narrow, name, mode="fast")
    _, sp = _resolvers(narrow, name, **MODES[split])
    np.testing.assert_array_equal(sp.upscale(narrow[1]), fast.upscale(narrow[1]))


def test_difvdsr_split_falls_back_to_patch(narrow, caplog):
    _, patch = _resolvers(narrow, "difvdsr", mode="patch")
    _, sp = _resolvers(narrow, "difvdsr", mode="split", split_tile=4)
    logger = logging.getLogger("image_enhance_keras_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        got = sp.upscale(narrow[1])
    finally:
        logger.removeHandler(caplog.handler)
    assert "no body/tail decomposition" in caplog.text
    np.testing.assert_array_equal(got, patch.upscale(narrow[1]))


def test_difvdsr_refines_the_bicubic_x4(narrow):
    """The pre-upscaled model's fast mode is the module on PIL-bicubic x4 of the input."""
    from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8

    _, pr = _resolvers(narrow, "difvdsr", mode="fast")
    img = narrow[1]
    up = resize_pil_uint8(torch.from_numpy(img), (80, 112))
    with torch.no_grad():
        y = pr.module(up[None] / 255.0)[0] * 255.0
    np.testing.assert_array_equal(pr.upscale(img), pr._finalize_u8(y).numpy())


@pytest.mark.parametrize("name", ["difvdsr", "difv4_x2"])
def test_frame_and_video_entry_points_match_jax(narrow, name):
    jr, pr = _resolvers(narrow, name)
    img = narrow[1]
    _assert_u8_close(pr.upscale_frame(img), np.asarray(jr.upscale_frame(img)))
    frames = np.stack([img, img[::-1]])
    _assert_u8_close(pr.upscale_video(frames), np.asarray(jr.upscale_video(frames)))


def _captured_calib(monkeypatch, resolver, target, attr):
    """The calibration batch the engine hands the int8 quantizer."""
    seen = []
    sup = target.int8_support(resolver.module)
    monkeypatch.setattr(target, attr, lambda m: (lambda p, c: seen.append(np.asarray(c)) or {}, *sup[1:]))
    resolver._fwd_params()
    return seen[0]


@pytest.mark.parametrize("source", ["images", "synthetic", "dir"])
def test_difvdsr_calibration_input_matches_jax(narrow, monkeypatch, tmp_path, source):
    """Pre-upscaled calibration: LR crops at x``scalemulti`` / 4, re-upscaled by PIL bicubic
    (the bundled photos, the synthetic tiles' round trip, or a calibration directory)."""
    jr, pr = _resolvers(narrow, "difvdsr", forward="int8")
    assert jr._calib_scale() == pr._calib_scale() == 4
    if source == "synthetic":
        jr.int8_calib = pr.int8_calib = "synthetic"
    if source == "dir":
        _bmp_write(str(tmp_path / "a.bmp"), np.random.default_rng(2).integers(0, 256, (72, 88, 3), dtype=np.uint8))
        jr.int8_calib_dir = pr.int8_calib_dir = str(tmp_path)
    want = _captured_calib(monkeypatch, jr, jax_zoo_int8, "int8_support")
    got = _captured_calib(monkeypatch, pr, port_engine, "int8_support")
    assert got.shape == want.shape and got.shape[1] % 4 == 0
    # PIL's rounding of exact .5 sums of the x4 bicubic weights follows the
    # float32 summation order: the engines' uint8 bound, in levels of 1/255
    d = np.rint(np.abs(got - want) * 255)
    assert d.max() <= MAX_DIFF and (d > 0).mean() <= MAX_FRAC, (d.max(), (d > 0).mean())


def test_pallas_forwards_refuse_the_subpixel_head(narrow):
    """JAX's pallas forwards run the TF1 x4 whatever the head; the port refuses them."""
    for forward in ("pallas", "pallas_chain", "pallas_int8"):
        with pytest.raises(ValueError, match="TF1 head only"):
            _resolvers(narrow, "didbl_subpixel", forward=forward)


def test_jax_pallas_forward_ignores_the_subpixel_head(narrow):
    """Documents the reference, not the port: JAX's apply_didbl_pallas on a
    subpixel model computes the TF1 x4 instead of its head, a different
    function from the module's (ROADMAP.md §3, standing differences)."""
    module, pn = narrow[0]["didbl_subpixel"]
    x = jnp.asarray(_x(6, (8, 8))[:1])
    want = np.asarray(module.apply({"params": pn}, x))
    got = np.asarray(jax_dp.apply_didbl_pallas(pn, x, n_body53=1, n_light=1, n_tail53=1, interpret=True))
    assert got.shape == want.shape and np.abs(got - want).max() > 1e-2


def test_registry_matches_jax():
    for name, spec in jax_zoo.MODEL_REGISTRY.items():
        got = port_zoo.MODEL_REGISTRY[name]
        assert (got.net_scale, got.pre_upscaled_input, got.default_weights, got.requires_divisible_shape) == \
            (spec.net_scale, spec.pre_upscaled_input, spec.default_weights, spec.requires_divisible_shape)
    assert isinstance(port_zoo.get_model("difv4_x2")[0], Difvdsr4) and port_zoo.get_model("difv4_x2")[0].scale == 2
    assert port_zoo.get_model("difvdsr")[0].frozen_params == ("level1",)
    with pytest.raises(KeyError, match="unknown model"):
        port_zoo.get_model("nope")


def test_cli_default_weights():
    for name in ("didbl_subpixel", "difv4", "difvdsr"):
        assert resolve_cli_weights(name, None).endswith(port_zoo.MODEL_REGISTRY[name].default_weights)
    with pytest.raises(SystemExit, match="no committed demo checkpoint"):
        resolve_cli_weights("difv4_x2", None)


@pytest.mark.parametrize("name", ["didbl_subpixel", "difv4", "difvdsr"])
def test_demo_checkpoint_forward_matches_jax(name):
    """The committed fp16 checkpoint in the full-width module, an 8x8 input."""
    spec = port_zoo.MODEL_REGISTRY[name]
    jmod, _ = jax_zoo.get_model(name)
    pn = load_params_npz(spec.default_weights)
    x = np.random.default_rng(7).random((1, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jmod.apply({"params": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), pn)},
                                 jnp.asarray(x)))
    mod, _ = port_zoo.get_model(name)
    load_params(mod, pn)
    assert all(p.dtype == torch.float32 for p in mod.parameters())
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.fixture()
def cli_setup(narrow, tmp_path, monkeypatch):
    """Both registries patched to the narrow models; weights in npz files."""
    models, img = narrow

    def jax_get(name, dtype=None, **kw):
        cfg, fcls, _, scale, pre = ZOO[name]
        return fcls(**cfg, dtype=dtype, **kw), jax_zoo.ModelSpec(name, None, scale, pre, "narrow", None)

    def port_get(name, dtype=None, **kw):
        cfg, _, pcls, scale, pre = ZOO[name]
        return pcls(**cfg, dtype=dtype, **kw), port_zoo.ModelSpec(name, None, scale, pre, "narrow", None)

    monkeypatch.setattr(jax_engine, "get_model", jax_get)
    monkeypatch.setattr(port_engine, "get_model", port_get)
    npz = {}
    for name, (_, pn) in models.items():
        npz[name] = str(tmp_path / f"{name}.npz")
        np.savez(npz[name], **flatten_params(pn))
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / side
        dirs[side].mkdir()
        _bmp_write(str(dirs[side] / "img.bmp"), img)
    return dirs, npz


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(ZOO))
def test_cli_matches_jax_cli(cli_setup, name, dtype):
    dirs, npz = cli_setup
    common = ["--model", name, "--weights", npz[name], "--mode", "fast", "--dtype", dtype]
    assert jax_main([str(dirs["jax"]), *common]) == 0
    assert port_main([str(dirs["port"]), *common, "--device", "cpu"]) == 0
    got = imread(str(dirs["port"] / "img_scaled(1x).bmp"))
    want = imread(str(dirs["jax"] / "img_scaled(1x).bmp"))
    if dtype == "float32":
        _assert_u8_close(got, want)
    else:
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < U8_FRAC


@pytest.mark.parametrize("name", ["difvdsr", "difv4"])
def test_evaluate_model_matches_jax(narrow, name, tmp_path):
    """evaluate_model: degrade, super-resolve (difvdsr through its pre-upscale), score."""
    for i, hw in enumerate([(40, 48), (36, 52)]):
        _bmp_write(str(tmp_path / f"g{i}.bmp"), np.random.default_rng(30 + i).integers(0, 256, (*hw, 3), dtype=np.uint8))
    jr, pr = _resolvers(narrow, name, mode="fast")
    _, want = jax_evaluate.evaluate_model(jr, str(tmp_path), crop_border=4, verbose=False)
    _, got = evaluate.evaluate_model(pr, str(tmp_path), crop_border=4, verbose=False)
    for k in ("psnr_y", "ssim_y", "ssim_rgb"):
        assert abs(got[k] - want[k]) <= (0.01 if k == "psnr_y" else 1e-4), (k, got[k], want[k])


def test_evaluate_divisible_driver_matches_jax(narrow, tmp_path):
    """A spec flagged requires_divisible_shape goes through the divisible-shape driver in both."""
    import dataclasses

    _bmp_write(str(tmp_path / "g.bmp"), np.random.default_rng(40).integers(0, 256, (37, 45, 3), dtype=np.uint8))
    jr, pr = _resolvers(narrow, "difv4", mode="fast")
    jr.spec = dataclasses.replace(jr.spec, requires_divisible_shape=True)
    pr.spec = dataclasses.replace(pr.spec, requires_divisible_shape=True)
    js, want = jax_evaluate.evaluate_model(jr, str(tmp_path), crop_border=4, verbose=False,
                                           save_dir=str(tmp_path / "j"))
    ps, got = evaluate.evaluate_model(pr, str(tmp_path), crop_border=4, verbose=False, save_dir=str(tmp_path / "p"))
    assert abs(got["psnr_y"] - want["psnr_y"]) <= 0.01 and abs(got["ssim_y"] - want["ssim_y"]) <= 1e-4
    assert (tmp_path / "p" / "difv4_g_generated.png").exists()


@pytest.mark.parametrize("name", ["didbl_subpixel", "difv4", "difvdsr"])
def test_scorpath_generate_matches_jax_cli(cli_setup, tmp_path, name):
    """``scorpath --generate --model M`` on one 40x52 image, fast-mode sizes kept small by patch tiles of 24/16."""
    _, npz = cli_setup
    d = tmp_path / "gt"
    d.mkdir()
    _bmp_write(str(d / "img.bmp"), np.random.default_rng(8).integers(0, 256, (40, 52, 3), dtype=np.uint8))
    jj, pj = tmp_path / "jax.json", tmp_path / "port.json"
    common = [str(d), "--generate", "--model", name, "--weights", npz[name], "--crop", "4"]
    assert jax_scorpath([*common, "--json", str(jj)]) == 0
    assert port_scorpath([*common, "--json", str(pj), "--device", "cpu"]) == 0
    want, got = json.loads(jj.read_text()), json.loads(pj.read_text())
    assert abs(got["psnr_y"] - want["psnr_y"]) <= 0.01 and abs(got["ssim_y"] - want["ssim_y"]) <= 1e-4
