"""Port's scoring stack against the JAX package on the CPU.

Colour transform, separable filter, PSNR / SSIM / GMSD, the directory
scorer, the evaluation loop with the bicubic baseline on Set5 and the
``scorpath`` CLI, with numpy-seeded inputs.  Float32 metrics summed in
another order: 1e-4 dB for PSNR, 1e-5 for SSIM and GMSD.  The numpy PNG
decoder is held bit-equal to PIL.
"""

import glob
import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu.cli.scorpath import main as jax_scorpath
from image_enhance_keras_tpu.eval import evaluate as jax_evaluate
from image_enhance_keras_tpu.eval import scorer as jax_scorer
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.ops import color as jax_color
from image_enhance_keras_tpu.ops import filters as jax_filters
from image_enhance_keras_tpu.ops import metrics as jax_metrics
from image_enhance_keras_tpu_torch.cli.scorpath import main as port_scorpath
from image_enhance_keras_tpu_torch.data import io
from image_enhance_keras_tpu_torch.eval import evaluate, scorer
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.weights import flatten_params
from image_enhance_keras_tpu_torch.ops import color, filters, metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SET5 = os.path.join(ROOT, "data_set5")
SET5_FILES = sorted(glob.glob(os.path.join(SET5, "*.png")))
DB_ATOL, UNIT_ATOL = 1e-4, 1e-5


def _img(h, w, seed, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _pair(seed):
    """A seeded image and a noisy copy of it, uint8."""
    a = _img(37, 45, seed)
    noise = np.random.default_rng(seed + 1).normal(0, 9, a.shape)
    return a, np.clip(np.round(a + noise), 0, 255).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- colour and filters ------------------------------------------------------

def test_color_transforms_match_jax():
    rgb = _img(19, 23, 1)
    np.testing.assert_allclose(color.rgb2ycbcr(_t(rgb)).numpy(), np.asarray(jax_color.rgb2ycbcr(rgb)),
                               atol=UNIT_ATOL * 100)
    np.testing.assert_allclose(color.rgb2y(_t(rgb)).numpy(), np.asarray(jax_color.rgb2y(rgb)),
                               atol=UNIT_ATOL * 100)
    ycc = np.asarray(jax_color.rgb2ycbcr(rgb))
    np.testing.assert_allclose(color.ycbcr2rgb(_t(ycc)).numpy(), np.asarray(jax_color.ycbcr2rgb(ycc)),
                               atol=1e-3)
    np.testing.assert_allclose(color.ycbcr2rgb(color.rgb2ycbcr(_t(rgb))).numpy(), rgb, atol=1e-3)
    np.testing.assert_array_equal(color.im2double(_t(rgb)).numpy(), np.asarray(jax_color.im2double(rgb)))
    np.testing.assert_allclose(color.im2double_minmax(_t(rgb)).numpy(),
                               np.asarray(jax_color.im2double_minmax(rgb)), atol=1e-7)


@pytest.mark.parametrize("shape", [(21, 17), (21, 17, 3), (2, 21, 17, 3)])
@pytest.mark.parametrize("kern", ["uniform7", "uniform4", "gauss1.5"])
def test_separable_filter_matches_jax(shape, kern):
    x = np.random.default_rng(2).random(shape).astype(np.float32) * 255
    k = (jax_filters._gaussian_kernel1d(1.5, truncate=3.5) if kern.startswith("gauss")
         else np.full((int(kern[-1]),), 1.0 / int(kern[-1]), np.float32))
    np.testing.assert_array_equal(filters._gaussian_kernel1d(1.5, 3.5), jax_filters._gaussian_kernel1d(1.5, 3.5))
    want = np.asarray(jax_filters.separable_filter2d(jnp.asarray(x), k, k[::-1].copy()))
    got = filters.separable_filter2d(_t(x), k, k[::-1].copy()).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-3)  # values up to 255: 4e-6 relative


# -- metrics -------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("psnr_nitre", {}), ("psnr_nitre", {"shave_border": 4}),
                                     ("psnr_vdsr", {}), ("psnr_shave", {"shave_border": 3}),
                                     ("psnr_peak1", {})])
def test_psnr_matches_jax(name, kw):
    a, b = _pair(3)
    want = float(getattr(jax_metrics, name)(jnp.asarray(b), jnp.asarray(a), **kw))
    got = float(getattr(metrics, name)(_t(b), _t(a), **kw))
    assert abs(got - want) <= DB_ATOL, (got, want)
    assert abs(float(metrics.mse(_t(b), _t(a))) - float(jax_metrics.mse(jnp.asarray(b), jnp.asarray(a)))) < 1e-3


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("kw", [{}, {"gaussian_weights": True}, {"win_size": 5, "use_sample_covariance": False}])
def test_ssim_matches_jax(channels, kw):
    a, b = _pair(4)
    if channels is None:  # 2-D: the Y channel
        a, b = np.asarray(jax_color.rgb2y(a)), np.asarray(jax_color.rgb2y(b))
    want = float(jax_metrics.ssim(jnp.asarray(b), jnp.asarray(a), data_range=255.0, **kw))
    got = float(metrics.ssim(_t(b), _t(a), data_range=255.0, **kw))
    assert abs(got - want) <= UNIT_ATOL, (got, want)


def test_ssim_rejects_bad_windows_and_shapes():
    a, b = _pair(5)
    with pytest.raises(ValueError, match="win_size"):
        metrics.ssim(_t(a), _t(b), win_size=4)
    with pytest.raises(ValueError, match="shape mismatch"):
        metrics.ssim(_t(a), _t(b[:-1]))
    with pytest.raises(ValueError, match="multichannel"):
        metrics.ssim(_t(a), _t(b), multichannel=False)


def test_gmsd_matches_jax():
    a, b = _pair(6)
    ya, yb = np.asarray(jax_color.rgb2y(a)), np.asarray(jax_color.rgb2y(b))
    want = float(jax_metrics.gmsd(jnp.asarray(yb), jnp.asarray(ya)))
    got = float(metrics.gmsd(_t(yb), _t(ya)))
    assert abs(got - want) <= UNIT_ATOL, (got, want)
    assert float(metrics.gmsd(_t(ya), _t(ya))) == 0.0


# -- scorer, evaluation loop ------------------------------------------------

def _assert_scores_close(got, want):
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        assert abs(g.psnr_y - w.psnr_y) <= DB_ATOL, (g, w)
        assert abs(g.ssim_y - w.ssim_y) <= UNIT_ATOL and abs(g.ssim_rgb - w.ssim_rgb) <= UNIT_ATOL, (g, w)
        if w.gmsd_y is not None:
            assert abs(g.gmsd_y - w.gmsd_y) <= UNIT_ATOL, (g, w)


@pytest.fixture(scope="module")
def set5_pairs(tmp_path_factory):
    """Set5 ground truths beside their PIL-bicubic x4 down-and-up round trips."""
    d = tmp_path_factory.mktemp("set5_pairs")
    for p in SET5_FILES:
        gt = Image.open(p).convert("RGB")
        w, h = gt.size
        gt.save(d / os.path.basename(p))
        up = gt.resize((w // 4, h // 4), Image.BICUBIC).resize((w, h), Image.BICUBIC)
        stem, ext = os.path.splitext(os.path.basename(p))
        up.save(d / f"{stem}_scaled(1x){ext}")
    return d


def test_score_directory_matches_jax(set5_pairs):
    want, wmeans = jax_scorer.score_directory(str(set5_pairs), verbose=False, with_gmsd=True)
    got, gmeans = scorer.score_directory(str(set5_pairs), verbose=False, with_gmsd=True, device="cpu")
    assert len(got) == 5
    _assert_scores_close(got, want)
    assert gmeans.keys() == wmeans.keys()
    assert scorer.find_pairs(str(set5_pairs)) == jax_scorer.find_pairs(str(set5_pairs))


def test_score_pair_shape_mismatch():
    a, b = _pair(7)
    with pytest.raises(ValueError, match="shape mismatch"):
        scorer.score_pair(a, b[:-2], device="cpu")
    got = scorer.score_pair(a, b[:-2], allow_shape_mismatch=True, device="cpu")
    want = jax_scorer.score_pair(a, b[:-2], allow_shape_mismatch=True)
    _assert_scores_close([got], [want])


def test_bicubic_evaluation_on_set5_matches_jax():
    want, wmeans = jax_evaluate.evaluate_resolver_on_dir(jax_evaluate.BicubicResolver(4), SET5, verbose=False)
    got, gmeans = evaluate.evaluate_resolver_on_dir(evaluate.BicubicResolver(4, device="cpu"), SET5,
                                                    verbose=False)
    _assert_scores_close(got, want)
    assert abs(gmeans["psnr_y"] - wmeans["psnr_y"]) <= DB_ATOL
    gt = io.imread(SET5_FILES[1])
    np.testing.assert_array_equal(evaluate.degrade(gt, 4, "cpu"), jax_evaluate.degrade(gt, 4))


# -- scorpath CLI --------------------------------------------------------------

def test_scorpath_directory_matches_jax_cli(set5_pairs, tmp_path):
    jj, pj = tmp_path / "jax.json", tmp_path / "port.json"
    assert jax_scorpath([str(set5_pairs), "--json", str(jj), "--gmsd"]) == 0
    assert port_scorpath([str(set5_pairs), "--json", str(pj), "--gmsd", "--device", "cpu"]) == 0
    want, got = json.loads(jj.read_text()), json.loads(pj.read_text())
    assert got.keys() == want.keys()
    assert abs(got["psnr_y"] - want["psnr_y"]) <= DB_ATOL
    for k in ("ssim_y", "ssim_rgb", "gmsd_y"):
        assert abs(got[k] - want[k]) <= UNIT_ATOL, k
    assert port_scorpath([str(tmp_path), "--device", "cpu"]) == 1  # nothing to score


NARROW = dict(features=16, n_body53=2, n_light=1, n_tail53=1)


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    module = FlaxDidbl(**NARROW)
    params = module.init(jax.random.PRNGKey(7), jnp.zeros((1, 16, 16, 3)))["params"]
    npz = tmp_path_factory.mktemp("tiny") / "tiny.npz"
    np.savez(npz, **flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    return module, str(npz)


@pytest.mark.parametrize("forward", ["xla", "pallas_chain"])
def test_scorpath_generate_matches_jax_cli(tiny_npz, tmp_path, monkeypatch, forward):
    """--generate on one 40x52 image with the narrow model, patch tiles of 24/16."""
    module, npz = tiny_npz
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "tiny", None)
    monkeypatch.setattr(jax_engine, "get_model", lambda name, dtype=None, **kw: (module, jspec))
    pspec = port_zoo.ModelSpec("didbl", lambda **k: DifvdsrDouble(**NARROW), 4, False, "tiny", None)
    monkeypatch.setattr(port_engine, "get_model", lambda name, dtype=None, **kw: (pspec.make(), pspec))
    for cls in (jax_engine.SuperResolver, port_engine.SuperResolver):  # small tiles for a small image
        orig = cls.__init__
        monkeypatch.setattr(cls, "__init__", lambda self, *a, _o=orig, **kw: _o(self, *a, patch=24, step=16, **kw))
    d = tmp_path / "gt"
    d.mkdir()
    Image.fromarray(_img(40, 52, 8)).save(d / "img.png")
    jj, pj = tmp_path / "jax.json", tmp_path / "port.json"
    common = [str(d), "--generate", "--weights", npz, "--forward", forward, "--crop", "4"]
    assert jax_scorpath([*common, "--json", str(jj)]) == 0
    assert port_scorpath([*common, "--json", str(pj), "--device", "cpu"]) == 0
    want, got = json.loads(jj.read_text()), json.loads(pj.read_text())
    # uint8 outputs of float32 forwards may flip a value on a rounding
    # boundary (tests/test_torch_engine.py): 1 level on at most 0.1% of
    # 40*52*3 values moves PSNR-Y by well under 0.01 dB
    assert abs(got["psnr_y"] - want["psnr_y"]) <= 0.01
    assert abs(got["ssim_y"] - want["ssim_y"]) <= 1e-4


@pytest.mark.parametrize("argv", [
    ["--model", "didbl_subpixel", "--internal-learn", "1"],
    ["--forward", "int8", "--model", "didbl_subpixel", "--internal-learn", "2"], ["--internal-learn", "3"],
    ["--forward", "int8", "--internal-learn", "1"], ["--model", "difvdsr", "--internal-learn", "1"],
    ["--forward", "int8", "--model", "difv4_x2", "--internal-learn", "1"], ["--model", "difv4", "--internal-learn", "4"],
])
def test_scorpath_rejects_unported_flags(tmp_path, argv):
    """Every flag of the JAX CLI now runs, ``--internal-learn`` too; what
    scorpath still refuses is an orbax checkpoint directory as ``--weights``
    (orbax imports JAX), whatever the model, forward or adaptation."""
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="an orbax checkpoint directory takes JAX"):
        port_scorpath([str(tmp_path), "--generate", "--device", "cpu", "--weights", str(orbax), *argv])


def test_scorpath_defaults_to_cuda(set5_pairs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_scorpath([str(set5_pairs)])


# -- the numpy PNG decoder -----------------------------------------------------

@pytest.fixture()
def no_pil(monkeypatch):
    """A machine without PIL or libpng: the numpy decoders read."""
    monkeypatch.setattr(io, "_pil", lambda: None)
    monkeypatch.setattr(io, "_native", lambda: None)


@pytest.mark.parametrize("path", SET5_FILES, ids=os.path.basename)
def test_png_decoder_matches_pil_on_set5(no_pil, path):
    want = np.asarray(Image.open(path).convert("RGB"))
    got = io.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_builtin_photos_without_pil_match_jax(no_pil):
    """The port's copies of the package-bundled calibration photos, read by
    the numpy decoder (as on a machine without PIL), equal the JAX package's
    ``builtin_photos`` read from the installed packages."""
    from image_enhance_keras_tpu.data import pipeline as jax_pipeline
    from image_enhance_keras_tpu_torch.data import pipeline

    want = jax_pipeline.builtin_photos()
    got = pipeline.builtin_photos()
    assert len(want) == len(pipeline._BUILTIN_PHOTO_SOURCES) == len(got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
def test_png_decoder_matches_pil_per_colour_type(no_pil, tmp_path, mode):
    im = Image.fromarray(_img(23, 31, 9, 4), "RGBA")
    im = im.convert("RGB").convert("P", palette=Image.ADAPTIVE, colors=256) if mode == "P" else im.convert(mode)
    path = tmp_path / f"{mode}.png"
    im.save(path)
    np.testing.assert_array_equal(io.imread(str(path)), np.asarray(Image.open(path).convert("RGB")))


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)


def _encode_png(img: np.ndarray, filters_cycle, ctype=2, interlace=0) -> bytes:
    """8-bit PNG whose rows use the given filter types in turn."""
    h, w, bpp = img.shape
    cur_all = img.astype(np.int16)
    rows = []
    for r in range(h):
        cur = cur_all[r]
        up = cur_all[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros((1, bpp), np.int16), cur[:-1]])
        upleft = np.concatenate([np.zeros((1, bpp), np.int16), up[:-1]])
        f = filters_cycle[r % len(filters_cycle)]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        pred = [0, left, up, (left + up) // 2, paeth][f]
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,bpp", [(2, 3), (6, 4), (0, 1)])
def test_png_decoder_undoes_every_row_filter(no_pil, tmp_path, ctype, bpp):
    img = _img(17, 13, 10, bpp)
    path = tmp_path / "filters.png"
    path.write_bytes(_encode_png(img, [0, 1, 2, 3, 4, 4, 3, 2, 1], ctype))
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(want[..., 0], img[..., 0])  # the encoder is right
    np.testing.assert_array_equal(io.imread(str(path)), want)


def test_png_decoder_refuses_what_it_does_not_read(no_pil, tmp_path):
    img = _img(5, 6, 11)
    cases = {
        "interlace": _encode_png(img, [0], interlace=1),
        "16-bit": Image.fromarray(_img(5, 6, 12, 1)[..., 0].astype(np.uint16) * 257),
        "crc": bytearray(_encode_png(img, [1])),
    }
    cases["crc"][-20] ^= 0xFF  # a byte of the IDAT payload
    for name, data in cases.items():
        path = tmp_path / f"{name}.png"
        if isinstance(data, Image.Image):
            data.save(path)
        else:
            path.write_bytes(bytes(data))
        with pytest.raises(ValueError, match="PNG"):
            io.imread(str(path))
