"""The training data plane in the port against the JAX package on the CPU.

``PatchSampler`` (with and without ``augment``, ``weights`` and ``moa``),
``moa_augment``, ``pinned_mass_weights``, ``load_image_dir`` and
``paired_patch_generator`` are numpy in both packages: their batches are
byte-equal from the same seed.  ``gaussian_blur`` and
``degrade_batch_on_device`` sum their float32 taps in another order than
JAX's convolutions, so a value rounded to a uint8 level may land one level
apart: within 1 level (1/255 after the scaling) on at most 0.1% of the
values.  ``sharpen_pil``'s weights are dyadic, so its sums are exact and
its output equal.  ``prepare_data`` writes the same HR patches and, its LR
patches being blurred, LR patches within the blur's bound; both CLIs'
parsers take the JAX package's arguments with the same defaults and
choices; ``Config`` round-trips through the JAX package's JSON.
"""

import argparse
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.data import augment as jax_augment
from image_enhance_keras_tpu.data import generator as jax_generator
from image_enhance_keras_tpu.data import pipeline as jax_pipeline
from image_enhance_keras_tpu.ops import filters as jax_filters
from image_enhance_keras_tpu.utils.config import Config as JaxConfig
from image_enhance_keras_tpu_torch.data import augment as port_augment
from image_enhance_keras_tpu_torch.data import generator as port_generator
from image_enhance_keras_tpu_torch.data import pipeline as port_pipeline
from image_enhance_keras_tpu_torch.data.io import imread, imwrite
from image_enhance_keras_tpu_torch.ops import filters as port_filters
from image_enhance_keras_tpu_torch.utils.config import Config as PortConfig

#: uint8-level outputs of float32 filters summed in other orders
MAX_LEVELS, MAX_FRAC = 1, 1e-3


def _images(seed=0, shapes=((40, 52), (64, 48), (33, 70))):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in shapes]


def _assert_levels_close(got, want, unit=1.0):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)) / unit
    assert got.shape == want.shape
    assert d.max() <= MAX_LEVELS + 1e-4 and (d > 1e-4).mean() <= MAX_FRAC, (d.max(), (d > 1e-4).mean())


@pytest.mark.parametrize("sigma", [0.5, 1.2, 0.0])
@pytest.mark.parametrize("shape", [(2, 24, 20, 3), (17, 13, 3), (9, 11)])
def test_gaussian_blur_matches_jax(sigma, shape):
    x = np.random.default_rng(1).integers(0, 256, shape).astype(np.float32)
    want = np.asarray(jnp.clip(jnp.round(jax_filters.gaussian_blur(jnp.asarray(x), sigma)), 0, 255))
    got = torch.clamp(torch.round(port_filters.gaussian_blur(torch.from_numpy(x), sigma)), 0, 255).numpy()
    _assert_levels_close(got, want)
    raw = port_filters.gaussian_blur(torch.from_numpy(x), sigma).numpy()
    np.testing.assert_allclose(raw, np.asarray(jax_filters.gaussian_blur(jnp.asarray(x), sigma)), atol=1e-4)


@pytest.mark.parametrize("shape", [(24, 20, 3), (2, 9, 7, 3), (6, 5)])
def test_sharpen_pil_matches_jax(shape):
    x = np.random.default_rng(2).integers(0, 256, shape).astype(np.float32)
    want = np.asarray(jax_filters.sharpen_pil(jnp.asarray(x)))
    got = port_filters.sharpen_pil(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale,blur", [(4, 0.5), (4, 0.0), (2, 0.5), (2, 1.0)])
def test_degrade_batch_matches_jax(scale, blur):
    hr = np.random.default_rng(3).integers(0, 256, (3, 32, 24, 3), dtype=np.uint8)
    want = np.asarray(jax_pipeline.degrade_batch_on_device(jnp.asarray(hr), scale=scale, blur_sigma=blur))
    got = port_pipeline.degrade_batch_on_device(torch.from_numpy(hr), scale=scale, blur_sigma=blur)
    assert got.dtype == torch.float32
    _assert_levels_close(got.numpy(), want, unit=1.0 / 255.0)
    # the same uint8 levels, scaled as JAX scales them
    levels = np.round(got.numpy() * 255.0)
    np.testing.assert_array_equal(got.numpy(), levels.astype(np.float32) / np.float32(255.0))


@pytest.mark.parametrize("kw", [
    dict(), dict(augment=True), dict(weights=[0.7, 0.2, 0.1]), dict(moa=0.8),
    dict(augment=True, moa=1.0, weights=[1.0, 0.0, 3.0], moa_ops=("mixup", "cutmix")),
])
def test_patch_sampler_byte_equal(kw):
    imgs = _images()
    a = jax_pipeline.PatchSampler(imgs, hr_patch=24, batch_size=5, seed=11, **kw)
    b = port_pipeline.PatchSampler(imgs, hr_patch=24, batch_size=5, seed=11, **kw)
    assert len(b.images) == len(a.images)
    for _ in range(4):
        np.testing.assert_array_equal(b.sample(), a.sample())


def test_patch_sampler_rejections():
    imgs = _images()
    for cls in (jax_pipeline.PatchSampler, port_pipeline.PatchSampler):
        with pytest.raises(ValueError):
            cls([], hr_patch=8)
        with pytest.raises(ValueError):
            cls(imgs, hr_patch=8, weights=[1.0])
        with pytest.raises(ValueError):
            cls(imgs, hr_patch=200)


@pytest.mark.parametrize("ops", [port_augment.MOA_OPS, ("blend",), ("rgb_perm", "cutmixup")])
@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_moa_augment_byte_equal(ops, prob):
    assert port_augment.MOA_OPS == jax_augment.MOA_OPS
    x = np.random.default_rng(4).integers(0, 256, (6, 16, 16, 3), dtype=np.uint8)
    want = jax_augment.moa_augment(x, np.random.default_rng(9), prob=prob, ops=ops)
    got = port_augment.moa_augment(x, np.random.default_rng(9), prob=prob, ops=ops)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown MoA ops"):
        port_augment.moa_augment(x, np.random.default_rng(0), ops=("cutblur",))


@pytest.mark.parametrize("args", [(4, 48, 0.5), (1, 9, 0.25), (0, 5, 0.5), (3, 0, 0.5), (2, 2, 1.7)])
def test_pinned_mass_weights_equal(args):
    assert port_pipeline.pinned_mass_weights(*args) == jax_pipeline.pinned_mass_weights(*args)


def test_load_image_dir_and_generator_equal(tmp_path):
    for sub, (n, side) in (("X", (5, 8)), ("y", (5, 16))):
        os.makedirs(tmp_path / "p" / sub)
        rng = np.random.default_rng(side)
        for i in range(n):
            imwrite(str(tmp_path / "p" / sub / f"0_{i}.png"), rng.integers(0, 256, (side, side, 3), dtype=np.uint8))
    a = jax_pipeline.load_image_dir(str(tmp_path / "p" / "y"), limit=3)
    b = port_pipeline.load_image_dir(str(tmp_path / "p" / "y"), limit=3)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert port_generator.image_count(str(tmp_path / "p")) == jax_generator.image_count(str(tmp_path / "p")) == 5
    ga = jax_generator.paired_patch_generator(str(tmp_path / "p"), batch_size=2, seed=3)
    gb = port_generator.paired_patch_generator(str(tmp_path / "p"), batch_size=2, seed=3)
    for _ in range(5):
        (ax, ay), (bx, by) = next(ga), next(gb)
        np.testing.assert_array_equal(bx, ax)
        np.testing.assert_array_equal(by, ay)


def test_config_fields_and_json_roundtrip(tmp_path):
    jf = {f.name: f.default if f.default is not dataclasses.MISSING else f.default_factory()
          for f in dataclasses.fields(JaxConfig)}
    pf = {f.name: f.default if f.default is not dataclasses.MISSING else f.default_factory()
          for f in dataclasses.fields(PortConfig)}
    assert pf == jf
    JaxConfig(model="difv4", lr=3e-4, model_kwargs={"features": 8}, clip_norm=1.0).save(str(tmp_path / "c.json"))
    got = PortConfig.from_file(str(tmp_path / "c.json"))
    assert got.model == "difv4" and got.lr == 3e-4 and got.model_kwargs == {"features": 8} and got.clip_norm == 1.0
    assert got.override(lr=None, epochs=3).epochs == 3 and got.override(lr=None).lr == 3e-4
    assert PortConfig(dtype="bfloat16").torch_dtype() is torch.bfloat16 and PortConfig().torch_dtype() is None


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs, a.const, a.required)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def _jax_prepare_parser():
    """The parser JAX's prepare_data.main builds (it has no build_parser)."""
    from image_enhance_keras_tpu.cli import prepare_data

    seen = []

    class _Stop(Exception):
        pass

    def capture(self, *a, **k):
        seen.append(self)
        raise _Stop

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(_Stop):
            prepare_data.main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen[0]


def test_cli_parsers_match_jax():
    from image_enhance_keras_tpu.cli.learn import build_parser as jax_learn
    from image_enhance_keras_tpu_torch.cli.learn import build_parser as port_learn
    from image_enhance_keras_tpu_torch.cli.prepare_data import build_parser as port_prepare

    for jp, pp in ((jax_learn(), port_learn()), (_jax_prepare_parser(), port_prepare())):
        want, got = _actions(jp), _actions(pp)
        assert got.pop("device") == (("--device",), "cuda", ["cuda", "cpu"], None, None, None, False)
        assert got == want


@pytest.mark.parametrize("kw", [dict(scale=2, img_size=48, stride=16),
                                dict(scale=4, img_size=64, stride=32, true_upscale=True, max_images=1),
                                dict(scale=2, img_size=40, stride=24, sharpen=False)])
def test_prepare_data_writes_jax_files(tmp_path, kw):
    from image_enhance_keras_tpu.cli.prepare_data import prepare as jax_prepare
    from image_enhance_keras_tpu_torch.cli.prepare_data import prepare as port_prepare

    src = tmp_path / "src"
    os.makedirs(src)
    for i, img in enumerate(_images(5, ((50, 62), (70, 45)))):
        imwrite(str(src / f"im{i}.png"), img)
    n_j = jax_prepare(str(src), str(tmp_path / "jax"), **kw)
    n_p = port_prepare(str(src), str(tmp_path / "port"), device="cpu", **kw)
    assert n_p == n_j > 0
    got, want = {}, {}
    for sub in ("X", "y"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "port" / sub)) == names
        got[sub] = np.stack([imread(str(tmp_path / "port" / sub / name)) for name in names])
        want[sub] = np.stack([imread(str(tmp_path / "jax" / sub / name)) for name in names])
    # HR patches: resize and sharpen are exact; LR patches: the blur's levels
    np.testing.assert_array_equal(got["y"], want["y"])
    _assert_levels_close(got["X"], want["X"])


def test_prepare_data_defaults_to_cuda(tmp_path, monkeypatch):
    from image_enhance_keras_tpu_torch.cli.prepare_data import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(tmp_path), str(tmp_path / "out")])
