"""The port's test-time extras and other entry points against the JAX package
on the CPU: the x8 self-ensemble, back-projection (``ops/backproject.py``,
PIL-bicubic ``resize_bicubic_pil``), the dense patch-average pass
(``tiling/dense.py``, ``upscale_patch_average``), ``upscale_frame`` and
``upscale_video``, and both CLIs with ``--self-ensemble`` and
``--back-projection``.

The narrow didbl (features 16, 2 + 1 + 1 blocks, flax init from key 3, as
``tests/test_torch_engine.py``) in float32.  The resizes and index plans
are held element for element (float resizes within 2e-4 of values up to
255, float32 contractions in other orders); engine outputs within the
float32 uint8 bound: 1 level on at most 0.1% of values.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.ops import backproject as jax_backproject
from image_enhance_keras_tpu.ops import resize as jax_resize
from image_enhance_keras_tpu.tiling import dense as jax_dense
from image_enhance_keras_tpu_torch.data.io import _bmp_write, imread
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.weights import flatten_params
from image_enhance_keras_tpu_torch.ops import backproject, resize
from image_enhance_keras_tpu_torch.tiling import dense

NARROW = dict(features=16, n_body53=2, n_light=1, n_tail53=1)
MAX_DIFF, MAX_FRAC = 1, 1e-3
#: float32 resizes of values in [0, 255]: two contractions summed in other orders
RESIZE_ATOL = 2e-4


def _assert_u8_close(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{what}: uint8 max diff {d.max()}, {(d > 0).mean():.3g} of values differ")
    assert d.max() <= MAX_DIFF and (d > 0).mean() <= MAX_FRAC


@pytest.mark.parametrize("src,dst", [((20, 28), (5, 7)), ((5, 7), (20, 28)), ((13, 9), (26, 27))])
def test_resize_bicubic_pil_matches_jax(src, dst):
    x = np.random.default_rng(0).uniform(0, 255, (2, *src, 3)).astype(np.float32)
    got = resize.resize_bicubic_pil(torch.from_numpy(x), dst).numpy()
    want = np.asarray(jax_resize.resize_bicubic_pil(jnp.asarray(x), dst))
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_back_project_matches_jax(iters, lead):
    rng = np.random.default_rng(iters)
    lr = rng.integers(0, 256, (*lead, 9, 11, 3), dtype=np.uint8)
    sr = rng.integers(0, 256, (*lead, 36, 44, 3), dtype=np.uint8)
    got = backproject.back_project(torch.from_numpy(sr), torch.from_numpy(lr), iters=iters).numpy()
    want = np.asarray(jax_backproject.back_project(jnp.asarray(sr), jnp.asarray(lr), iters=iters))
    _assert_u8_close(got, want, f"back_project x{iters} {lead}")
    with pytest.raises(ValueError, match="integer multiple"):
        backproject.back_project(torch.from_numpy(sr[..., :-1, :, :]), torch.from_numpy(lr))


@pytest.mark.parametrize("hw,patch,step,pad", [((20, 28), 8, 4, 0), ((32, 48), 16, 8, 4), ((37, 29), 12, 5, 2)])
def test_dense_patches_match_jax(hw, patch, step, pad):
    x = np.random.default_rng(2).normal(size=(*hw, 3)).astype(np.float32)
    got = dense.extract_dense_patches(torch.from_numpy(x), patch, step)
    want = jax_dense.extract_dense_patches(jnp.asarray(x), patch, step)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx, mask, counts = dense._scatter_plan(*hw, patch, step, pad)
    for a, b in zip((idx, mask, counts), jax_dense._scatter_plan(*hw, patch, step, pad)):
        np.testing.assert_array_equal(a, b)
    y = np.random.default_rng(3).uniform(0, 255, got.shape).astype(np.float32)
    rec = dense.reconstruct_average(torch.from_numpy(y), hw, step=step, pad=pad).numpy()
    np.testing.assert_allclose(rec, np.asarray(jax_dense.reconstruct_average(jnp.asarray(y), hw, step=step, pad=pad)),
                               rtol=0, atol=RESIZE_ATOL)
    u8 = dense.reconstruct_average(torch.from_numpy(y.astype(np.uint8)), hw, step=step, pad=pad)
    assert u8.dtype == torch.float32


@pytest.fixture(scope="module")
def narrow():
    params = FlaxDidbl(**NARROW).init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))["params"]
    img = np.random.default_rng(11).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    return jax.tree_util.tree_map(np.asarray, params), img


@pytest.fixture()
def patched(monkeypatch):
    jspec = jax_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    pspec = port_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    monkeypatch.setattr(jax_engine, "get_model",
                        lambda name, dtype=None, **kw: (FlaxDidbl(dtype=dtype, **NARROW, **kw), jspec))
    monkeypatch.setattr(port_engine, "get_model",
                        lambda name, dtype=None, **kw: (DifvdsrDouble(dtype=dtype, **NARROW, **kw), pspec))


def _pair(pn, **kw):
    jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn), **kw)
    pr = port_engine.SuperResolver(params=pn, device="cpu", **kw)
    return jr, pr


@pytest.mark.parametrize("hw", [(20, 28), (16, 16)])
def test_self_ensemble_matches_jax(narrow, patched, hw):
    pn, img = narrow
    img = np.ascontiguousarray(img[: hw[0], : hw[1]])
    jr, pr = _pair(pn, mode="fast", self_ensemble=True)
    got = pr.upscale(img)
    assert got.shape == (4 * hw[0], 4 * hw[1], 3)
    _assert_u8_close(got, np.asarray(jr.upscale(img)), f"self-ensemble {hw}")
    _, plain = _pair(pn, mode="fast")
    assert not np.array_equal(got, plain.upscale(img))


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("ensemble", [False, True])
def test_back_projection_matches_jax(narrow, patched, iters, ensemble):
    pn, img = narrow
    jr, pr = _pair(pn, mode="fast", back_projection=iters, self_ensemble=ensemble)
    _assert_u8_close(pr.upscale(img), np.asarray(jr.upscale(img)), f"back-projection x{iters}, ensemble {ensemble}")


def test_patch_average_matches_jax(narrow, patched):
    pn, img = narrow
    big = np.random.default_rng(12).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    jr, pr = _pair(pn)
    got = pr.upscale_patch_average(big, patch=16, step=8)
    assert got.shape == big.shape
    _assert_u8_close(got, np.asarray(jr.upscale_patch_average(big, patch=16, step=8)), "patch average")


@pytest.mark.parametrize("iters", [0, 1])
def test_upscale_frame_matches_jax(narrow, patched, iters):
    pn, img = narrow
    jr, pr = _pair(pn, back_projection=iters)
    got = pr.upscale_frame(img)
    assert got.shape == (80, 112, 3)
    _assert_u8_close(got, np.asarray(jr.upscale_frame(img)), f"upscale_frame, back-projection {iters}")


@pytest.mark.parametrize("iters", [0, 1])
def test_upscale_video_matches_jax(narrow, patched, iters):
    pn, img = narrow
    frames = np.stack([np.roll(img, 3 * t, axis=1) for t in range(3)])
    jr, pr = _pair(pn, back_projection=iters)
    got = pr.upscale_video(frames, frame_chunk=2)
    assert got.shape == (3, 80, 112, 3)
    want = np.asarray(jr.upscale_video(frames, frame_chunk=2))
    _assert_u8_close(got, want, f"upscale_video, back-projection {iters}")
    for t in range(3):  # chunking changes the schedule, not the frames
        np.testing.assert_array_equal(got[t], pr.upscale_frame(frames[t]))


def test_cli_extras_match_jax_cli(narrow, patched, tmp_path):
    from image_enhance_keras_tpu.cli.main_dirpath import main as jax_main
    from image_enhance_keras_tpu_torch.cli.main_dirpath import main as port_main

    pn, img = narrow
    npz = tmp_path / "narrow.npz"
    np.savez(npz, **flatten_params(pn))
    common = ["--weights", str(npz), "--mode", "split", "--split-tile", "8", "--self-ensemble",
              "--back-projection", "2"]
    outs = {}
    for name, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        _bmp_write(str(d / "img.bmp"), img)
        assert main([str(d), *common, *extra]) == 0
        outs[name] = imread(str(d / "img_scaled(1x).bmp"))
    _assert_u8_close(outs["port"], outs["jax"], "main_dirpath --self-ensemble --back-projection 2")


def test_scorpath_generate_extras_match_jax_cli(narrow, patched, tmp_path, monkeypatch):
    """--generate --self-ensemble --back-projection 1 on one 40x52 image (patch mode, 24/16 tiles)."""
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
    common = [str(d), "--generate", "--weights", str(npz), "--self-ensemble", "--back-projection", "1", "--crop", "4"]
    assert jax_scorpath([*common, "--json", str(jj)]) == 0
    assert port_scorpath([*common, "--json", str(pj), "--device", "cpu"]) == 0
    want, got = json.loads(jj.read_text()), json.loads(pj.read_text())
    print(f"scorpath --generate --self-ensemble --back-projection 1: port {got['psnr_y']:.4f} / "
          f"{got['ssim_y']:.5f}, JAX {want['psnr_y']:.4f} / {want['ssim_y']:.5f}")
    # 1 level on at most 0.1% of the values moves PSNR-Y by well under 0.01 dB
    assert abs(got["psnr_y"] - want["psnr_y"]) <= 0.01
    assert abs(got["ssim_y"] - want["ssim_y"]) <= 1e-4
