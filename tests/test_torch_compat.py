"""The port's ``compat`` (the reference-named surface) against the JAX package's on the CPU.

Every name of JAX's ``compat.__all__`` exists in the port's.  The array
helpers are held to JAX's on seeded inputs: tiling and patch extraction
exactly, overlap-average reconstructions within the float32 sum-order bound
of tests/test_torch_extras.py (2e-4 at 0..255), float scores within 1e-6.
``DifvdsrDouble`` runs a narrow didbl injected as JAX's tests/test_compat.py
injects one (flax's init carried into the port): its outputs equal the
port's ``SuperResolver`` byte for byte, and JAX's ``compat`` within the
float32 engine bound of tests/test_torch_engine.py (one level on at most
0.1% of the values).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu import compat as jax_compat
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu_torch import compat
from image_enhance_keras_tpu_torch.data.io import imread, imwrite
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.train.checkpoints import STATE_FILE

NARROW = dict(features=8, n_body53=1, n_light=1, n_tail53=1)
RECON_ATOL = 2e-4
MAX_DIFF, MAX_FRAC = 1, 1e-3


def _u8_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= MAX_DIFF and (d > 0).mean() <= MAX_FRAC, (d.max(), (d > 0).mean())


def test_every_name_of_jax_compat():
    assert set(jax_compat.__all__) <= set(compat.__all__)
    for name in jax_compat.__all__:
        assert hasattr(compat, name), name
    for name in ("_image_scale_multiplier", "img_size", "stride"):
        assert getattr(compat, name) == getattr(jax_compat, name)
    import image_enhance_keras_tpu_torch as pkg

    assert pkg.compat is compat


def test_step_tiling_exact():
    img = np.random.default_rng(0).integers(0, 256, (256, 320, 3)).astype(np.float64)
    got, grid = compat.extract_patches_Step(img, (96, 96), 64)
    want, jgrid = jax_compat.extract_patches_Step(img, (96, 96), 64)
    assert grid == jgrid and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want))
    for scale in (1, 4):
        p = np.repeat(np.repeat(got, scale, 1), scale, 2)
        np.testing.assert_array_equal(compat.rebuild_from_patches_Step(img, p, (96, 96), grid, scale, 64),
                                      jax_compat.rebuild_from_patches_Step(img, p, (96, 96), grid, scale, 64))
    with pytest.raises(ValueError, match="square"):
        compat.extract_patches_Step(img, (96, 64), 64)


def test_dense_patch_surface():
    img = np.random.default_rng(7).random((13, 11, 3)).astype(np.float32) * 255
    for name, args in (("make_patches", (img, 1, 4)), ("make_patchesOrig", (img, 1, 4)),
                       ("extract_patches_2dlocal", (img, None, (4, 4), 2))):
        np.testing.assert_array_equal(getattr(compat, name)(*args), np.asarray(getattr(jax_compat, name)(*args)))
    np.testing.assert_array_equal(compat.make_patchesStep(img, 1, 4, extraction_step=3),
                                  jax_compat.make_patchesStep(img, 1, 4, extraction_step=3))
    patches = compat.make_patches(img, 1, 4)
    np.testing.assert_allclose(compat.combine_patches(patches, (13, 11, 3), 1),
                               jax_compat.combine_patches(patches, (13, 11, 3), 1), atol=RECON_ATOL, rtol=0)
    sparse = compat.extract_patches_2dlocal(img, None, (4, 4), step=2)
    np.testing.assert_allclose(compat.reconstruct_from_patches_2dlocal(None, sparse, (13, 11), step=2),
                               jax_compat.reconstruct_from_patches_2dlocal(None, sparse, (13, 11), step=2),
                               atol=RECON_ATOL, rtol=0)


def test_scores_within_1e_6():
    rng = np.random.default_rng(1)
    gt = rng.integers(0, 256, (32, 30, 3)).astype(np.float64)
    pred = np.clip(gt + rng.normal(0, 4, gt.shape), 0, 255)
    for name, args in (("psnrNITRE", (pred, gt)), ("psnrNITRE", (pred, gt, 4)), ("psnrVDSR", (pred, gt, 4)),
                       ("PSNRTorch", (pred, gt, 2)), ("psnrSVLAB", (pred / 255, gt / 255)),
                       ("psnr", (gt / 255, pred / 255)), ("psnr2", (gt, pred)), ("psnr3", (gt, pred)),
                       ("PSNRLoss", (gt, pred)), ("PSNRLossTest", (gt / 255, pred / 255))):
        got, want = getattr(compat, name)(*args), getattr(jax_compat, name)(*args)
        assert isinstance(got, float) == isinstance(want, float), name
        assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want))), (name, got, want)
    assert compat.psnr2(gt, gt) == jax_compat.psnr2(gt, gt) == 100
    np.testing.assert_array_equal(compat.im2double(gt), jax_compat.im2double(gt))
    np.testing.assert_array_equal(compat.im2doubleZ(gt), jax_compat.im2doubleZ(gt))


def test_color_and_resize():
    img = np.random.default_rng(2).integers(0, 256, (17, 15, 3), dtype=np.uint8)
    np.testing.assert_allclose(compat.rgb2y(img), jax_compat.rgb2y(img), atol=1e-4, rtol=0)
    for size in ((34, 30), (9, 7)):
        got = compat.imresize_bicubic(img, size)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_compat.imresize_bicubic(img, size))


def test_adjust_and_labels():
    img = np.random.default_rng(3).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    for gamma in (0.5, 0.1, 2.0):
        np.testing.assert_array_equal(compat.SetGama(img, gamma), jax_compat.SetGama(img, gamma))
    for c in (64, 128, -50):
        np.testing.assert_array_equal(compat.SetContrast(img, c), jax_compat.SetContrast(img, c))
    y = (np.random.default_rng(4).random((6, 4)) > 0.5).astype(int)
    np.random.seed(5)
    got = compat.smooth_gan_labels(y)
    np.random.seed(5)
    np.testing.assert_array_equal(got, jax_compat.smooth_gan_labels(y))


def test_grid_patches():
    img = np.random.default_rng(6).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    built = compat.subimage_build_patch_global(img, 8, 16)
    np.testing.assert_array_equal(built, jax_compat.subimage_build_patch_global(img, 8, 16))
    np.testing.assert_array_equal(np.stack(list(compat.subimage_patch(img, 8, 16))),
                                  np.stack(list(jax_compat.subimage_patch(img, 8, 16))))
    np.testing.assert_array_equal(compat.subimage_combine_patches_global(img, built, 8, 16, 1),
                                  jax_compat.subimage_combine_patches_global(img, built, 8, 16, 1))
    with pytest.raises(ValueError, match="patches were given"):
        compat.subimage_combine_patches_global(img, built[:3], 8, 16, 2)


def test_extract_patches_2dv2():
    img = np.random.default_rng(4).integers(0, 256, (24, 30, 3), dtype=np.uint8)
    gray = img[..., 0]
    for args, kw in (((img, (8, 12)), {}), ((img, (8, 8)), dict(max_patches=5, random_state=7)),
                     ((img, (8, 8)), dict(max_patches=0.01, random_state=0)), ((gray, (6, 6)), {})):
        np.testing.assert_array_equal(compat.extract_patches_2dv2(*args, **kw),
                                      jax_compat.extract_patches_2dv2(*args, **kw))
    with pytest.raises(ValueError):
        compat.extract_patches_2dv2(img, (64, 64))


def test_transform_images_and_generator(tmp_path):
    """The prepared pairs (reference stop condition included) and the
    generator's batches: HR patches exact, LR within the blur's levels
    (tests/test_torch_data.py); shape-contract errors as JAX's."""
    rng = np.random.default_rng(6)
    src = tmp_path / "src"
    src.mkdir()
    for name in ("a", "b", "c"):
        imwrite(str(src / f"{name}.png"), rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    n = compat.transform_images(str(src), str(tmp_path / "port"), scaling_factor=2, max_nb_images=3, device="cpu")
    assert n == jax_compat.transform_images(str(src), str(tmp_path / "jax"), scaling_factor=2, max_nb_images=3)
    names = sorted(os.listdir(tmp_path / "jax" / "y"))
    assert sorted(os.listdir(tmp_path / "port" / "y")) == names and len({f.split("_")[0] for f in names}) == 2
    for name in names:
        np.testing.assert_array_equal(imread(str(tmp_path / "port" / "y" / name)),
                                      imread(str(tmp_path / "jax" / "y" / name)))
    assert compat.image_count(str(tmp_path / "port")) == jax_compat.image_count(str(tmp_path / "jax"))
    for kw in (dict(), dict(small_train_images=True), dict(target_shape=(32, 32))):
        bx, by = next(compat.image_generator(str(tmp_path / "port"), scale_factor=2, batch_size=4, seed=0, **kw))
        jx, jy = next(jax_compat.image_generator(str(tmp_path / "jax"), scale_factor=2, batch_size=4, seed=0, **kw))
        assert bx.shape == jx.shape and by.shape == jy.shape and bx.dtype == np.float32
        np.testing.assert_array_equal(by, jy)
        assert np.abs(bx - jx).max() <= 2 / 255 + 1e-6
    with pytest.raises(ValueError, match="do not fit"):
        next(compat.image_generator(str(tmp_path / "port"), scale_factor=4, batch_size=4))


# -- DifvdsrDouble ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    module = FlaxDidbl(**NARROW)
    params = module.init(jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, 3)))["params"]
    return module, params, jax.tree_util.tree_map(np.asarray, params)


def _models(tiny, monkeypatch, patch=24, step=16):
    """JAX's and the port's compat class, each with the narrow model injected."""
    module, params, pn = tiny
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "tiny", None)
    pmod = DifvdsrDouble(**NARROW)
    pspec = port_zoo.ModelSpec("didbl", lambda **k: pmod, 4, False, "tiny", None)
    jm, pm = jax_compat.DifvdsrDouble(scale_factor=1), compat.DifvdsrDouble(scale_factor=1, device="cpu")
    jm._resolver = jax_engine.SuperResolver(params=params, module_and_spec=(module, jspec), patch=patch, step=step)
    pm._resolver = port_engine.SuperResolver(params=pn, module_and_spec=(pmod, pspec), patch=patch, step=step,
                                             device="cpu")
    ref = port_engine.SuperResolver(params=pn, module_and_spec=(pmod, pspec), patch=patch, step=step, device="cpu")
    return jm, pm, ref


def test_upscale_step_patch_and_video(tiny, monkeypatch, tmp_path):
    jm, pm, ref = _models(tiny, monkeypatch)
    img = np.random.default_rng(8).integers(0, 256, (30, 34, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    imwrite(p, img)
    dst = pm.upscaleStepPatch(p, patch_size=24, step_patch=16)
    assert dst.endswith("x_scaled(1x).png")
    got = imread(dst)
    np.testing.assert_array_equal(got, ref.upscale(img))
    _u8_close(got, np.asarray(jm.upscaleStepPatch(p, patch_size=24, step_patch=16, return_image=True)))
    # another geometry retargets the resolver's tile plan, as JAX's does
    out = pm.upscaleStepPatch(p, patch_size=32, step_patch=8, return_image=True)
    assert (pm._resolver.patch, pm._resolver.step) == (32, 8) and pm._resolver.plan_for(30, 34).patch == 32
    ref.patch, ref.step = 32, 8
    np.testing.assert_array_equal(out, ref.upscale(img))
    _u8_close(out, np.asarray(jm.upscaleStepPatch(p, patch_size=32, step_patch=8, return_image=True)))
    frame = np.random.default_rng(9).integers(0, 256, (16, 18, 3), dtype=np.uint8)
    v = pm.upVideo(frame)
    np.testing.assert_array_equal(v, ref.upscale_frame(frame))
    _u8_close(v, np.asarray(jm.upVideo(frame)))


def test_upscale_patch_and_legacy_upscale(tiny, monkeypatch, tmp_path):
    """upscalePatch (step 4) and the legacy upscale (step 16) are the port's
    patch-average; their intermediates equal JAX's files; mode='fast' is the frame."""
    jm, pm, ref = _models(tiny, monkeypatch)
    img = np.random.default_rng(10).integers(0, 256, (36, 40, 3), dtype=np.uint8)
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        imwrite(str(tmp_path / side / "img.png"), img)
    pp, jp = str(tmp_path / "port" / "img.png"), str(tmp_path / "jax" / "img.png")
    with pytest.raises(ValueError, match="scalemulti"):
        pm.upscalePatch(pp, patch_size=16, scalemulti=2)
    for method, step in (("upscalePatch", 4), ("upscale", 16)):
        out = getattr(pm, method)(pp, patch_size=16, save_intermediate=True, return_image=True)
        np.testing.assert_array_equal(out, ref.upscale_patch_average(img, patch=16, step=step))
        _u8_close(out, np.asarray(getattr(jm, method)(jp, patch_size=16, save_intermediate=True,
                                                      return_image=True)))
        inter = "img_intermediate_.png"
        np.testing.assert_array_equal(imread(str(tmp_path / "port" / inter)), imread(str(tmp_path / "jax" / inter)))
        dst = getattr(pm, method)(pp, patch_size=16)
        assert dst.endswith("img_scaled(1x).png") and imread(dst).shape == (36, 40, 3)
    fast = pm.upscale(pp, mode="fast", save_intermediate=True, return_image=True)
    np.testing.assert_array_equal(fast, ref.upscale_frame(img))
    np.testing.assert_array_equal(imread(str(tmp_path / "port" / "img_intermediate_.png")), img)


def test_weights_resolution(tmp_path, monkeypatch):
    """The committed demo npz in a fresh clone; a complete checkpoint of the
    port's trainer ("best" with its state file) wins, re-resolved at load
    time; an incomplete one is passed over; no checkpoint refuses to serve."""
    import shutil

    m = compat.DifvdsrDouble(scale_factor=1, device="cpu")
    assert m.weight_path.endswith("didbl_set5demo.npz") and os.path.exists(m.weight_path)
    demo = os.path.abspath(m.weight_path)
    monkeypatch.chdir(tmp_path)
    os.makedirs("weights_Double/best")
    shutil.copy(demo, "weights_Double/didbl_set5demo.npz")
    m = compat.DifvdsrDouble(scale_factor=1, device="cpu")
    assert m.weight_path.endswith(".npz")  # best/ holds no state file yet
    (tmp_path / "weights_Double" / "best" / STATE_FILE).write_bytes(b"")
    captured = {}
    monkeypatch.setattr(port_engine, "SuperResolver", lambda model="didbl", weights=None, **kw: captured.update(
        weights=weights, **kw))
    m.create_model(load_weights=True)
    assert captured == dict(weights="weights_Double/best", device="cpu")
    from image_enhance_keras_tpu_torch.models import zoo

    monkeypatch.setattr(compat.DifvdsrDouble, "WEIGHT_CANDIDATES", ("weights_Double/nonexistent",))
    monkeypatch.setattr(zoo, "resolve_default_weights", lambda spec: None)
    with pytest.raises(FileNotFoundError, match="random-init"):
        compat.DifvdsrDouble(scale_factor=1, device="cpu").upscaleStepPatch("whatever.png")


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = compat.DifvdsrDouble(scale_factor=1)
    assert m.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.create_model(load_weights=True)


def test_fit_and_evaluate(tiny, monkeypatch, tmp_path):
    """fit() refuses without patches and trains from train_images/train/y on
    the port's Trainer (narrow model, two steps); evaluate() is the port's
    evaluate_model on the resolver."""
    import image_enhance_keras_tpu_torch.train.trainer as trainer_mod
    import image_enhance_keras_tpu_torch.utils.config as config_mod
    from image_enhance_keras_tpu_torch.eval import evaluate_model

    monkeypatch.chdir(tmp_path)
    m = compat.DifvdsrDouble(scale_factor=1, device="cpu")
    with pytest.raises(FileNotFoundError, match="no training patches"):
        m.fit()
    os.makedirs("train_images/train/y")
    for i in range(3):
        imwrite(f"train_images/train/y/p{i}.png", np.random.default_rng(i).integers(0, 256, (32, 32, 3), np.uint8))

    class Small(config_mod.Config):
        def __init__(self, **kw):
            super().__init__(**kw, steps_per_epoch=2, model_kwargs=NARROW)

    monkeypatch.setattr(config_mod, "Config", Small)
    hist = m.fit(batch_size=2, nb_epochs=1, save_history=True, history_fn="hist.txt")
    assert os.path.exists("hist.txt") and os.path.isdir("weights_Double")
    import ast

    assert ast.literal_eval(open("hist.txt").read()) == hist
    assert trainer_mod.Trainer is not None
    _, pm, ref = _models(tiny, monkeypatch)
    os.makedirs("gt")
    imwrite("gt/a.png", np.random.default_rng(11).integers(0, 256, (32, 36, 3), np.uint8))
    assert pm.evaluate("gt") == evaluate_model(ref, "gt")
