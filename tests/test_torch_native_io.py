"""The port's native codec (``runtime/native_io.py``) and ``data/io.py`` against JAX's.

The port builds ``native/iek_io.cpp`` itself; JAX loads its own build of
the same source.  Every decode is held byte-equal (``np.array_equal``) to
JAX's ``data.io.imread`` and, where PIL reads the file, to PIL; the batch
loader and the patch gather to JAX's native ones; the hardening cases of
``tests/test_native_io.py`` hold here too.  Skipped where the library
cannot be built (no ``g++`` or no libpng headers).
"""

import os

import numpy as np
import pytest
from PIL import Image

from image_enhance_keras_tpu.data import io as jax_io
from image_enhance_keras_tpu.runtime import native_io as jax_native
from image_enhance_keras_tpu_torch.data import io
from image_enhance_keras_tpu_torch.runtime import native_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native_io.available():
        pytest.skip(f"the native codec does not build here: {native_io.unavailable_reason()}")


def _img(h, w, seed, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _write(kind: str, path: str) -> None:
    """One file of each format the codec reads."""
    if kind == "png":
        Image.fromarray(_img(33, 47, 0)).save(path)
    elif kind == "png_grey":
        Image.fromarray(_img(16, 16, 1)[..., 0], mode="L").save(path)
    elif kind == "png_palette":
        Image.fromarray(_img(8, 8, 2)).quantize(16).save(path)
    elif kind == "png_rgba":
        Image.fromarray(_img(9, 13, 3, 4), "RGBA").save(path)
    elif kind == "bmp":
        Image.fromarray(_img(21, 33, 4)).save(path)
    elif kind == "bmp32":
        Image.fromarray(_img(7, 5, 5, 4), "RGBA").save(path)
    elif kind == "ppm":
        assert native_io.imwrite(path, _img(9, 11, 6))
    elif kind == "golden_bmp":  # the reference's butterfly_GT.bmp, made from the Set5 PNG
        Image.open(os.path.join(ROOT, "data_set5", "butterfly_GT.png")).convert("RGB").save(path)


KINDS = {"png": ".png", "png_grey": ".png", "png_palette": ".png", "png_rgba": ".png", "bmp": ".bmp",
         "bmp32": ".bmp", "ppm": ".ppm", "golden_bmp": ".bmp"}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_matches_jax(tmp_path, kind):
    path = str(tmp_path / f"f{KINDS[kind]}")
    _write(kind, path)
    got = io.imread(path)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, jax_io.imread(path))
    np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))
    native = native_io.imread(path)
    if native is not None:
        np.testing.assert_array_equal(native, got)


@pytest.mark.parametrize("ext", [".png", ".bmp", ".ppm"])
def test_write_matches_jax_bytes(tmp_path, ext):
    img = _img(17, 23, 7)
    ours, theirs = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    io.imwrite(ours, img)
    jax_io.imwrite(theirs, img)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(io.imread(ours), img)


def test_native_png_is_read_by_the_numpy_decoder(tmp_path):
    img = _img(31, 45, 8)
    p = str(tmp_path / "n.png")
    assert native_io.imwrite(p, img)
    np.testing.assert_array_equal(io._png_read(p), img)


def test_batch_loader_matches_jax(tmp_path):
    paths = []
    for i in range(9):
        p = str(tmp_path / f"{i}.png")
        Image.fromarray(_img(10 + i, 20, 10 + i)).save(p)
        paths.append(p)
    paths.append(str(tmp_path / "missing.png"))
    got = native_io.imread_batch(paths, threads=4)
    want = jax_native.imread_batch(paths, threads=4)
    assert got[-1] is None and want[-1] is None
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g, w)
    assert native_io.imread_batch([]) == []


@pytest.mark.parametrize("case", ["corners", "empty"])
def test_gather_patches_matches_jax(case):
    img = _img(32, 40, 11)
    ys, xs = (np.array([0, 5, 24]), np.array([0, 10, 32])) if case == "corners" else ([], [])
    got = native_io.gather_patches(img, ys, xs, 8)
    want = jax_native.gather_patches(img, ys, xs, 8)
    assert got.shape == want.shape == (len(ys), 8, 8, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_hardening(tmp_path):
    """tests/test_native_io.py's hardening cases: a PPM header with a comment,
    an unsupported suffix leaves an existing file alone, float input is
    clipped and rounded, bad shapes and corner lists raise."""
    img = _img(6, 7, 5)
    ppm = str(tmp_path / "c.ppm")
    with open(ppm, "wb") as f:
        f.write(b"P6\n# created by GIMP\n7 6\n255\n" + img.tobytes())
    np.testing.assert_array_equal(native_io.imread(ppm), img)
    keep = tmp_path / "keep.tif"
    keep.write_bytes(b"precious")
    assert native_io.imwrite(str(keep), img) is False
    assert keep.read_bytes() == b"precious"
    f32 = img.astype(np.float32)
    f32[0, 0] = [300.2, -5.0, 128.6]
    p = str(tmp_path / "f.png")
    assert native_io.imwrite(p, f32)
    assert tuple(native_io.imread(p)[0, 0]) == (255, 0, 129)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        native_io.gather_patches(img[..., 0], [0], [0], 4)
    with pytest.raises(ValueError, match="len"):
        native_io.gather_patches(img, [0, 1], [0], 4)
    with pytest.raises(ValueError, match="out of range"):
        native_io.gather_patches(img, [3], [0], 4)


def test_truncated_png_falls_back_and_raises(tmp_path):
    """A file the native codec refuses goes on to PIL, which raises as JAX's does."""
    p = tmp_path / "t.png"
    Image.fromarray(_img(20, 20, 12)).save(p)
    p.write_bytes(p.read_bytes()[:60])
    assert native_io.imread(str(p)) is None
    with pytest.raises(OSError):
        io.imread(str(p))
    with pytest.raises(OSError):
        jax_io.imread(str(p))


def test_unbuildable_library_is_not_available(tmp_path, monkeypatch):
    """No source (or no compiler): available() is False with the reason kept,
    and data/io.py serves through the other codecs."""
    source = native_io.SOURCE
    native_io._load.cache_clear()
    monkeypatch.setattr(native_io, "SOURCE", str(tmp_path / "missing.cpp"))
    assert not native_io.available()
    assert "missing.cpp" in native_io.unavailable_reason()
    assert native_io.imread(str(tmp_path / "x.png")) is None and not native_io.imwrite(str(tmp_path / "x.png"),
                                                                                       _img(2, 2, 0))
    img = _img(5, 6, 13)
    io.imwrite(str(tmp_path / "y.png"), img)  # PIL
    np.testing.assert_array_equal(io.imread(str(tmp_path / "y.png")), img)
    native_io._load.cache_clear()
    monkeypatch.setattr(native_io, "SOURCE", source)
    monkeypatch.setattr(native_io, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native_io, "BUILD_DIR", str(tmp_path / "build"))
    try:
        assert not native_io.available() and "no-such-compiler" in native_io.unavailable_reason()
    finally:
        native_io._load.cache_clear()  # the next caller loads the real build


def test_build_is_named_by_source_and_flags():
    path = native_io._target()
    assert os.path.dirname(path) == native_io.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path).startswith("libiek_io-") and path.endswith(".so")
