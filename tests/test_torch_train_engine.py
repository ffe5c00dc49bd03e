"""Internal learning (``--internal-learn``) in the port against the JAX package on the CPU.

A narrow didbl (8 features, 2 + 1 + 1 blocks) with flax's init in both
engines and a seeded, structured 32x32 image.  ``_internal_adapt`` runs
JAX's settings (``PatchSampler(seed=0, augment=True)``, HR patches of
min(64, ..), Adam 2e-5, charbonnier, no blur, the frozen mask) and gives
JAX's adapted params within the train step's bound
(tests/test_torch_train_step.py: 1e-6 where Adam's update is not
dominated by its eps).  The image served with them is within 1 level of
JAX's on at most 0.1% of the values (float32 forwards summed in other
orders).  After the call the module and its params are the base ones,
and the next image without adaptation gives a fresh engine's bytes.
``--forward int8`` is in tests/test_torch_train_int8.py.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu.cli.main_dirpath import main as jax_main
from image_enhance_keras_tpu.cli.scorpath import main as jax_scorpath
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.models.difvdsr import Difvdsr as FlaxDifvdsr
from image_enhance_keras_tpu_torch.cli.main_dirpath import main as port_main
from image_enhance_keras_tpu_torch.cli.scorpath import main as port_scorpath
from image_enhance_keras_tpu_torch.data.io import _bmp_write, imread
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.difvdsr import Difvdsr
from image_enhance_keras_tpu_torch.models.weights import flatten_params, params_of_module

NARROW = dict(features=8, n_body53=2, n_light=1, n_tail53=1)
PARAM_ATOL, STEP_BOUND = 1e-6, 2e-5
MAX_DIFF, MAX_FRAC = 1, 1e-3
#: two int8 forwards' uint8 outputs (tests/test_torch_engine.py)
INT8_MAX_DIFF, INT8_MAX_FRAC = 3, 0.05
STEPS = 3


def _image(side=32, seed=73):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side]
    img = np.stack([yy * 4, xx * 4, (yy + xx) * 2], -1) + rng.integers(0, 32, (side, side, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def narrow():
    module = FlaxDidbl(**NARROW)
    params = module.init(jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 3)))["params"]
    return module, jax.tree_util.tree_map(np.asarray, params)


def _engines(narrow, il=STEPS, **kw):
    module, pn = narrow
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "narrow", None)
    jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn), module_and_spec=(module, jspec),
                                  patch=24, step=16, internal_learn=il, **kw)
    pmod = DifvdsrDouble(**NARROW)
    pspec = port_zoo.ModelSpec("didbl", lambda **k: pmod, 4, False, "narrow", None)
    pr = port_engine.SuperResolver(params=pn, module_and_spec=(pmod, pspec), patch=24, step=16,
                                   internal_learn=il, device="cpu", **kw)
    for r in (jr, pr):
        r.internal_learn_batch = 2
    return jr, pr


def _gap(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def _assert_adapted_close(got: dict, want: dict, base: dict):
    """Within 1e-6 wherever Adam moved the param by more than a tenth of its
    step (elsewhere the update is eps-dominated: within the steps' size)."""
    assert set(got) == set(want)
    for k, w in want.items():
        moved = np.abs(w - base[k]) > 0.1 * 2e-5
        d = np.abs(got[k] - w)
        assert d[moved].max(initial=0.0) <= PARAM_ATOL, (k, d[moved].max())
        assert d.max() <= STEPS * STEP_BOUND, (k, d.max())


def test_internal_adapt_matches_jax(narrow):
    jr, pr = _engines(narrow)
    img = _image()
    base = flatten_params(narrow[1])
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jr._internal_adapt(img, STEPS)))
    with torch.inference_mode():  # as upscale calls it
        adapted = pr._internal_adapt(img, STEPS)
    got = {k: v.numpy() for k, v in flatten_params(params_of_module(adapted)).items()}
    _assert_adapted_close(got, want, base)
    assert any(not np.array_equal(got[k], base[k]) for k in base)
    # the engine's own module and params are untouched
    for k, v in flatten_params(pr.params).items():
        np.testing.assert_array_equal(v.numpy(), base[k])
    assert not any(p.requires_grad for p in adapted.parameters())


@pytest.mark.parametrize("kw", [dict(mode="fast"), dict(mode="patch"), dict(mode="fast", forward="pallas"),
                                dict(mode="split", split_tile=4)])
def test_internal_learn_serves_adapted_and_restores(narrow, kw):
    jr, pr = _engines(narrow, **kw)
    img = _image()
    module0, params0 = pr.module, pr.params
    base_out = port_engine.SuperResolver(params=narrow[1], module_and_spec=(
        DifvdsrDouble(**NARROW), port_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)),
        patch=24, step=16, device="cpu", **kw).upscale(img)
    got, want = pr.upscale(img), np.asarray(jr.upscale(img))
    dmax, frac = _gap(got, want)
    assert got.shape == (128, 128, 3) and dmax <= MAX_DIFF and frac <= MAX_FRAC, (dmax, frac)
    assert not np.array_equal(got, base_out)  # the adapted weights were served
    assert pr.module is module0 and pr.params is params0
    for k, v in flatten_params(pr.params).items():
        np.testing.assert_array_equal(v.numpy(), flatten_params(narrow[1])[k])
    pr.internal_learn = 0
    np.testing.assert_array_equal(pr.upscale(img), base_out)


def test_internal_learn_too_small_serves_base(narrow, caplog, monkeypatch):
    monkeypatch.setattr(logging.getLogger("image_enhance_keras_tpu_torch"), "propagate", True)
    _, pr = _engines(narrow, il=2, mode="fast")
    tiny = np.random.default_rng(1).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    with caplog.at_level(logging.WARNING):
        out = pr.upscale(tiny)
    assert out.shape == (32, 32, 3)
    assert any("too small" in r.getMessage() for r in caplog.records)
    pr.internal_learn = 0
    np.testing.assert_array_equal(pr.upscale(tiny), out)


def test_internal_learn_keeps_frozen_params():
    """difvdsr's frozen entry conv is not adapted, in either package."""
    cfg = dict(features=8, n_blocks=2)
    module = FlaxDifvdsr(**cfg)
    pn = jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 3)))["params"])
    jspec = jax_zoo.ModelSpec("difvdsr", lambda **k: module, 1, True, "narrow", None)
    jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn), module_and_spec=(module, jspec),
                                  mode="fast", internal_learn=2)
    pspec = port_zoo.ModelSpec("difvdsr", None, 1, True, "narrow", None)
    pr = port_engine.SuperResolver(params=pn, module_and_spec=(Difvdsr(**cfg), pspec), mode="fast",
                                   internal_learn=2, device="cpu")
    for r in (jr, pr):
        r.internal_learn_batch = 2
    img = _image(24)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jr._internal_adapt(img, 2)))
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in flatten_params(params_of_module(pr._internal_adapt(img, 2))).items()}
    base = flatten_params(pn)
    for k in ("level1/kernel", "level1/bias"):
        np.testing.assert_array_equal(got[k], base[k])
        np.testing.assert_array_equal(want[k], base[k])
    assert not np.array_equal(got["out/kernel"], base["out/kernel"])
    assert np.abs(got["out/kernel"] - want["out/kernel"]).max() <= 2 * STEP_BOUND


@pytest.fixture()
def cli_setup(narrow, tmp_path, monkeypatch):
    """Both registries patched to the narrow model; its weights in an npz; a seeded BMP."""
    module, pn = narrow
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "narrow", None)
    monkeypatch.setattr(jax_engine, "get_model", lambda name, dtype=None, **kw: (module, jspec))
    pspec = port_zoo.ModelSpec("didbl", lambda **k: DifvdsrDouble(**NARROW), 4, False, "narrow", None)
    monkeypatch.setattr(port_engine, "get_model", lambda name, dtype=None, **kw: (pspec.make(), pspec))
    npz = tmp_path / "narrow.npz"
    np.savez(npz, **flatten_params(pn))
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        _bmp_write(str(dirs[name] / "img.bmp"), _image())
    return dirs, str(npz)


def test_main_dirpath_internal_learn_matches_jax_cli(cli_setup):
    dirs, npz = cli_setup
    common = ["--weights", npz, "--mode", "fast", "--internal-learn", "2", "--internal-learn-lr", "1e-4"]
    assert jax_main([str(dirs["jax"]), *common]) == 0
    assert port_main([str(dirs["port"]), *common, "--device", "cpu"]) == 0
    got, want = imread(str(dirs["port"] / "img_scaled(1x).bmp")), imread(str(dirs["jax"] / "img_scaled(1x).bmp"))
    dmax, frac = _gap(got, want)
    assert got.shape == (128, 128, 3) and dmax <= MAX_DIFF and frac <= MAX_FRAC, (dmax, frac)


def test_scorpath_internal_learn_matches_jax(cli_setup, tmp_path):
    dirs, npz = cli_setup
    jj, pj = tmp_path / "j.json", tmp_path / "p.json"
    common = [str(dirs["jax"]), "--generate", "--weights", npz, "--internal-learn", "1", "--crop", "4"]
    assert jax_scorpath([*common, "--json", str(jj)]) == 0
    assert port_scorpath([*common, "--json", str(pj), "--device", "cpu"]) == 0
    want, got = json.loads(jj.read_text()), json.loads(pj.read_text())
    assert abs(got["psnr_y"] - want["psnr_y"]) <= 0.01 and abs(got["ssim_y"] - want["ssim_y"]) <= 1e-4
