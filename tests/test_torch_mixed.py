"""The port's mixed and mixed-tail profiles against the JAX package on the CPU.

``mixed`` is JAX's ``_CONV_F32ACC`` conv: x, kernel and bias rounded to
bf16, a float32 conv of those values emitting float32, the rounded bias
added in float32, float32 combines.  ``mixed-tail`` keeps the body pure
bf16 and mixes only the tail.  The narrow didbl (features 16, 2 + 1 + 1
blocks), the same numpy-seeded inputs and weights in both packages.

Bounds:

* one mixed block: within 3e-5 of JAX, at most 1e-3 of the elements
  beyond (a float32 sum in another order can flip the bf16 rounding of a
  conv input);
* a mixed module forward: such a flip moves the next conv's input by a
  bf16 ulp, and the later bf16 roundings carry it on, as in a bf16 chain:
  JAX's 5x5 convs sum in another order than torch's (its 3x3 convs agree
  bit for bit), and on the narrow model at 20x28 a few flips put 3% of the
  outputs beyond 3e-5 (the count is printed).  So the forward is held to
  the bf16 chain bound of ``tests/test_torch_bf16.py``: max |d| at most
  2^-6 max|ref|, mean |d| at most 1e-4 max|ref|;
* mixed-tail, whose body is the bf16 profile's: the bf16 profile's whole-
  forward bounds (uint8 within 1 level on under 3% of values, mean |d| of
  the float outputs at most 0.025 levels);
* engines and CLIs, both profiles: the bf16 profile's uint8 bound, 1 level
  on under 3% of values (the counts are printed);
* the ``pallas*`` forwards take only the dtype (bf16) under either mixed
  profile, and ``pallas_int8`` no dtype at all: byte-equal, in JAX and in
  the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu_torch.engine as port_engine
import image_enhance_keras_tpu_torch.models.blocks as port_blocks
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu.models.blocks import Light53Block as FlaxLight53, LightBlock as FlaxLight
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu_torch.data.io import _bmp_write, imread
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.blocks import Light53Block, LightBlock
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.weights import flatten_params, load_params
from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_tf1

NARROW = dict(features=16, n_body53=2, n_light=1, n_tail53=1)
#: one block: |d| bound and the share of elements allowed beyond it
BLOCK_ATOL, BLOCK_FRAC = 3e-5, 1e-3
#: a module forward: max and mean |d| as fractions of max|ref| (bf16 chain bound)
CHAIN_MAX, CHAIN_MEAN = 2.0 ** -6, 1e-4
#: uint8 outputs within 1 level on under U8_FRAC; mean |d| in levels
U8_FRAC, MEAN_LEVELS = 0.03, 0.025
PROFILES = {"mixed": True, "mixed-tail": "tail"}


def _flax_params(module, x, seed):
    """Flax init, then random biases (zero biases would hide a bias rounded the wrong way)."""
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(size=v.shape) * 0.05).astype(np.float32) if p[-1].key == "bias"
        else np.asarray(v), params)


@pytest.mark.parametrize("which", ["light53", "light"])
def test_mixed_block_matches_jax(which):
    x = np.random.default_rng(2).normal(size=(2, 12, 14, 16)).astype(np.float32)
    flax_cls, port_cls = {"light53": (FlaxLight53, Light53Block), "light": (FlaxLight, LightBlock)}[which]
    fm = flax_cls(16, dtype=jnp.bfloat16, mixed=True)
    params = _flax_params(fm, x, 1)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    pm = port_cls(16, dtype=torch.bfloat16, mixed=True)
    load_params(pm, params)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    d = np.abs(got - want)
    print(f"mixed {which} block: max |d| {d.max():.3g}, {(d > BLOCK_ATOL).sum()} of {d.size} beyond {BLOCK_ATOL}")
    assert (d > BLOCK_ATOL).mean() <= BLOCK_FRAC


def test_mixed_conv_rounds_operands_and_emits_float32():
    """A float32 conv of the bf16-rounded x and kernel plus the bf16-rounded bias, in float32."""
    conv = port_blocks.Conv(4, 3, (3, 3), torch.bfloat16, mixed=True)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        conv.kernel.copy_(torch.randn(conv.kernel.shape, generator=g))
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=g))
        x = torch.randn(1, 5, 6, 4, generator=g)
        got = conv(x)
        bf = torch.bfloat16
        want = port_blocks.conv2d_nhwc(x.to(bf).float(), conv.kernel.to(bf).float()) + conv.bias.to(bf).float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, port_blocks.conv2d_nhwc(x, conv.kernel, conv.bias))


@pytest.fixture(scope="module")
def narrow():
    """Flax init of the narrow didbl from key 3 (as tests/test_torch_engine.py), numpy
    params, and a seeded 20x28 uint8 image."""
    params = FlaxDidbl(**NARROW).init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))["params"]
    img = np.random.default_rng(11).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    return jax.tree_util.tree_map(np.asarray, params), img


def _forwards(pn, x, **kw):
    fm = FlaxDidbl(dtype=jnp.bfloat16, **NARROW, **kw)
    want = np.asarray(fm.apply({"params": pn}, jnp.asarray(x)))
    pm = DifvdsrDouble(dtype=torch.bfloat16, **NARROW, **kw)
    load_params(pm, pn)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    return pm, got, want


def test_mixed_module_matches_jax(narrow):
    pn, img = narrow
    x = (img[None].astype(np.float32) / 255.0)
    _, got, want = _forwards(pn, x, mixed=True)
    assert got.dtype == want.dtype == np.float32
    d, ref = np.abs(got - want), float(np.abs(want).max())
    print(f"mixed module: max |d| {d.max():.3g}, mean {d.mean():.3g}, max|ref| {ref:.3g}, "
          f"{(d > BLOCK_ATOL).sum()} of {d.size} beyond {BLOCK_ATOL}")
    assert d.max() <= CHAIN_MAX * ref and d.mean() <= CHAIN_MEAN * ref


def test_mixed_tail_module_matches_jax(narrow):
    pn, img = narrow
    x = (img[None].astype(np.float32) / 255.0)
    _, got, want = _forwards(pn, x, mixed_tail=True)
    assert got.dtype == want.dtype == np.float32
    u8 = np.abs(np.clip(np.round(got * 255), 0, 255) - np.clip(np.round(want * 255), 0, 255))
    mean_levels = float(np.abs(got - want).mean() * 255)
    print(f"mixed-tail module: uint8 max diff {u8.max()}, {(u8 > 0).mean():.3g} differ, mean {mean_levels:.3g} levels")
    assert u8.max() <= 1 and (u8 > 0).mean() < U8_FRAC and mean_levels <= MEAN_LEVELS


def test_mixed_tail_promotes_in_first_tail_block(narrow):
    """The body is bf16; the first tail block's 0.9 * x promotes the bf16 x4 output
    to float32 (JAX's promotion); every later activation is float32."""
    pn, img = narrow
    pm = DifvdsrDouble(dtype=torch.bfloat16, mixed_tail=True, **NARROW)
    load_params(pm, pn)
    x = torch.from_numpy(img[None].astype(np.float32) / 255.0)
    with torch.no_grad():
        h = pm.body(x)
        assert h.dtype == torch.bfloat16
        t = pm.tail53_0(upsample_phase_tf1(h, 4))
    assert t.dtype == torch.float32


@pytest.fixture()
def patched(monkeypatch):
    """Both registries build the narrow didbl in the asked profile."""
    jspec = jax_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    pspec = port_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    monkeypatch.setattr(jax_engine, "get_model",
                        lambda name, dtype=None, **kw: (FlaxDidbl(dtype=dtype, **NARROW, **kw), jspec))
    monkeypatch.setattr(port_engine, "get_model",
                        lambda name, dtype=None, **kw: (DifvdsrDouble(dtype=dtype, **NARROW, **kw), pspec))


def _upscale_pair(pn, img, **kw):
    jkw = dict(kw)
    if jkw.get("dtype") == "bfloat16":
        jkw["dtype"] = jnp.bfloat16
    jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn), **jkw)
    pr = port_engine.SuperResolver(params=pn, device="cpu", **kw)
    return np.asarray(jr.upscale(img)), pr.upscale(img), pr


def _u8_gap(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("mode", ["fast", "patch"])
@pytest.mark.parametrize("profile", list(PROFILES))
def test_mixed_engine_matches_jax(narrow, patched, profile, mode):
    pn, img = narrow
    want, got, pr = _upscale_pair(pn, img, mixed=PROFILES[profile], mode=mode, patch=24, step=16)
    assert pr._dtype == torch.bfloat16 and pr.module.dtype == torch.bfloat16
    dmax, frac = _u8_gap(got, want)
    print(f"engine {profile} {mode}: uint8 max diff {dmax}, {frac:.3g} of values differ")
    assert dmax <= 1 and frac < U8_FRAC


@pytest.mark.parametrize("forward", ["pallas", "pallas_chain"])
@pytest.mark.parametrize("profile", list(PROFILES))
def test_pallas_mixed_equals_bf16(narrow, patched, forward, profile):
    pn, img = narrow
    want_bf, got_bf, _ = _upscale_pair(pn, img, forward=forward, mode="fast", dtype="bfloat16")
    want, got, pr = _upscale_pair(pn, img, forward=forward, mode="fast", mixed=PROFILES[profile])
    assert pr._dtype == torch.bfloat16
    np.testing.assert_array_equal(want, want_bf)  # JAX
    np.testing.assert_array_equal(got, got_bf)  # the port


@pytest.fixture(scope="module")
def int8_qparams(narrow):
    """The narrow model's calibrated int8 trees, once for the module: (JAX's, the port's)."""
    pn, _ = narrow
    jspec = jax_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    pspec = port_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn), forward="pallas_int8",
                                  module_and_spec=(FlaxDidbl(**NARROW), jspec))
    pr = port_engine.SuperResolver(params=pn, forward="pallas_int8", device="cpu",
                                   module_and_spec=(DifvdsrDouble(**NARROW), pspec))
    return jr._fwd_params(), pr._fwd_params()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed", "mixed-tail"])
def test_pallas_int8_runs_under_every_dtype(narrow, patched, int8_qparams, dtype):
    """pallas_int8 takes no dtype: the same int8 forward (and the same quantized
    tree) as float32, in both packages; and the port equals JAX bit for bit."""
    pn, img = narrow
    kw = {"float32": {}, "bfloat16": dict(dtype="bfloat16"), "mixed": dict(mixed=True),
          "mixed-tail": dict(mixed="tail")}[dtype]
    outs = []
    for extra in ({}, kw):
        jkw = dict(extra)
        if jkw.get("dtype") == "bfloat16":
            jkw["dtype"] = jnp.bfloat16
        jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn), forward="pallas_int8",
                                      mode="fast", **jkw)
        pr = port_engine.SuperResolver(params=pn, forward="pallas_int8", mode="fast", device="cpu", **extra)
        jr._qparams, pr._qparams = int8_qparams
        outs.append((np.asarray(jr.upscale(img)), pr.upscale(img)))
    (jf, pf), (jd, pd) = outs
    np.testing.assert_array_equal(jd, jf)
    np.testing.assert_array_equal(pd, pf)
    np.testing.assert_array_equal(pd, jd)


# -- the CLIs --------------------------------------------------------------------

@pytest.fixture()
def narrow_cli(narrow, patched, tmp_path):
    pn, img = narrow
    npz = tmp_path / "narrow.npz"
    np.savez(npz, **flatten_params(pn))
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        _bmp_write(str(dirs[name] / "img.bmp"), img)
    return dirs, str(npz)


@pytest.mark.parametrize("forward", ["xla", "pallas", "pallas_chain", "pallas_int8"])
@pytest.mark.parametrize("profile", list(PROFILES))
def test_cli_mixed_matches_jax_cli(narrow_cli, monkeypatch, int8_qparams, profile, forward):
    from image_enhance_keras_tpu.cli.main_dirpath import main as jax_main
    from image_enhance_keras_tpu_torch.cli.main_dirpath import main as port_main

    if forward == "pallas_int8":  # the module's calibrated trees, not a calibration per run
        for engine, qp in zip((jax_engine, port_engine), int8_qparams):
            monkeypatch.setattr(engine.SuperResolver, "_fwd_params", lambda self, _qp=qp: _qp)
    dirs, npz = narrow_cli
    common = ["--weights", npz, "--forward", forward, "--dtype", profile, "--mode", "fast"]
    assert jax_main([str(dirs["jax"]), *common]) == 0
    assert port_main([str(dirs["port"]), *common, "--device", "cpu"]) == 0
    got = imread(str(dirs["port"] / "img_scaled(1x).bmp"))
    want = imread(str(dirs["jax"] / "img_scaled(1x).bmp"))
    assert got.shape == (80, 112, 3) and want.std() > 10.0
    dmax, frac = _u8_gap(got, want)
    print(f"main_dirpath --dtype {profile} --forward {forward}: uint8 max diff {dmax}, {frac:.3g} differ")
    if forward == "pallas_int8":
        assert dmax == 0
    else:
        assert dmax <= 1 and frac < U8_FRAC


def test_scorpath_generate_mixed_matches_jax_cli(narrow, patched, tmp_path, monkeypatch):
    """--generate --dtype mixed on one 40x52 image in patch mode (24/16 tiles)."""
    from PIL import Image

    from image_enhance_keras_tpu.cli.scorpath import main as jax_scorpath
    from image_enhance_keras_tpu_torch.cli.scorpath import main as port_scorpath

    pn, _ = narrow
    npz = tmp_path / "narrow.npz"
    np.savez(npz, **flatten_params(pn))
    for cls in (jax_engine.SuperResolver, port_engine.SuperResolver):  # small tiles for a small image
        orig = cls.__init__
        monkeypatch.setattr(cls, "__init__", lambda self, *a, _o=orig, **kw: _o(self, *a, patch=24, step=16, **kw))
    d = tmp_path / "gt"
    d.mkdir()
    Image.fromarray(np.random.default_rng(8).integers(0, 256, (40, 52, 3), dtype=np.uint8)).save(d / "img.png")
    jj, pj = tmp_path / "jax.json", tmp_path / "port.json"
    common = [str(d), "--generate", "--weights", str(npz), "--dtype", "mixed", "--crop", "4"]
    assert jax_scorpath([*common, "--json", str(jj)]) == 0
    assert port_scorpath([*common, "--json", str(pj), "--device", "cpu"]) == 0
    want, got = json.loads(jj.read_text()), json.loads(pj.read_text())
    print(f"scorpath --generate --dtype mixed: port {got['psnr_y']:.4f} / {got['ssim_y']:.5f}, "
          f"JAX {want['psnr_y']:.4f} / {want['ssim_y']:.5f}")
    # 1 level on under 3% of the values moves PSNR-Y by under 0.05 dB and SSIM-Y by under 1e-3
    assert abs(got["psnr_y"] - want["psnr_y"]) <= 0.05
    assert abs(got["ssim_y"] - want["ssim_y"]) <= 1e-3
