"""The port's serving runtime against its serial loop and against JAX's, on the CPU.

``runtime.serving.serve_directory``, ``main_dirpath --pipeline`` and
``--save_intermediate``, and the ``python -m`` front door.  The narrow
didbl (features 8, one block of each kind) with the same weights in both
packages, a directory of 24x24 images.  Tolerances: the pipelined outputs
equal the serial ones byte for byte (the files); ``--save_intermediate``
writes JAX's file name and pixels (decoded bytes equal); against JAX's
``serve_directory`` run op by op (``jax.disable_jit()``, which the port's
int8 forward follows: tests/test_torch_int8_xla.py) the int8 outputs are
equal (decoded bytes); against the jitted one the float32 outputs, whose
convolutions sum in another order, differ by at most 1 level on at most
0.1% of the values, as ``tests/test_torch_engine.py`` holds the engines.
"""

import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu.cli.main_dirpath import main as jax_main
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.runtime.serving import serve_directory as jax_serve
from image_enhance_keras_tpu_torch import __main__ as front
from image_enhance_keras_tpu_torch.cli.main_dirpath import main as port_main
from image_enhance_keras_tpu_torch.data import io as port_io
from image_enhance_keras_tpu_torch.data.io import imread, imwrite
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.weights import flatten_params
from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8
from image_enhance_keras_tpu_torch.runtime import native_io, serving

NARROW = dict(features=8, n_body53=1, n_light=1, n_tail53=1)
BOUNDS = {"xla": (1, 1e-3)}
INPUTS = ("a.png", "b.bmp", "c.png")


@pytest.fixture(scope="module")
def tiny():
    module = FlaxDidbl(**NARROW)
    params = module.init(jax.random.PRNGKey(5), jnp.zeros((1, 16, 16, 3)))["params"]
    return module, jax.tree_util.tree_map(np.asarray, params)


def _resolvers(tiny, forward):
    module, pn = tiny
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "tiny", None)
    jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn), module_and_spec=(module, jspec),
                                  mode="fast", forward=forward)
    pmod = DifvdsrDouble(**NARROW)
    pspec = port_zoo.ModelSpec("didbl", lambda **k: pmod, 4, False, "tiny", None)
    pr = port_engine.SuperResolver(params=pn, module_and_spec=(pmod, pspec), mode="fast", forward=forward,
                                   device="cpu")
    # int8: both calibrate on one of the served images (the engines' first-frame calibration input)
    calib = np.random.default_rng(20).integers(0, 256, (1, 24, 24, 3), np.uint8).astype(np.float32) / 255.0
    jr._calib_x, pr._calib_x = jnp.asarray(calib), torch.from_numpy(calib)
    return jr, pr


def _make_dir(path, extra=()) -> str:
    """Three 24x24 images, an output of an earlier run and an intermediate (both skipped)."""
    os.makedirs(path, exist_ok=True)
    for i, name in enumerate(INPUTS):
        imwrite(os.path.join(path, name), np.random.default_rng(20 + i).integers(0, 256, (24, 24, 3), np.uint8))
    imwrite(os.path.join(path, "old_scaled(1x).png"), np.zeros((8, 8, 3), np.uint8))
    imwrite(os.path.join(path, "old_intermediate_.png"), np.zeros((8, 8, 3), np.uint8))
    for name, data in extra:
        with open(os.path.join(path, name), "wb") as f:
            f.write(data)
    return str(path)


def _outputs(path) -> dict:
    return {n: open(os.path.join(path, n), "rb").read() for n in sorted(os.listdir(path)) if "_scaled(1x)" in n
            and not n.startswith("old")}


def _assert_u8_close(got, want, forward):
    most, frac = BOUNDS[forward]
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= most and (d > 0).mean() <= frac, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("forward", ["xla", "int8"])
def test_serve_directory_matches_serial_and_jax(tiny, tmp_path, forward):
    jr, pr = _resolvers(tiny, forward)
    serial, piped, theirs = (_make_dir(tmp_path / d) for d in ("serial", "piped", "jax"))
    pr.upscale_dir(serial)
    stats = serving.serve_directory(pr, piped, decode_threads=2, encode_threads=2, lookahead=2)
    assert (stats.images, stats.out_pixels) == (3, 3 * 96 * 96) and stats.out_mpix_s > 0
    assert stats.device_s > 0 and stats.decode_s > 0 and stats.encode_s > 0
    want = _outputs(serial)
    assert sorted(want) == ["a_scaled(1x).png", "b_scaled(1x).bmp", "c_scaled(1x).png"]
    assert _outputs(piped) == want  # the files, byte for byte
    with jax.disable_jit(forward == "int8"):  # int8: JAX op by op, which the port follows
        jstats = jax_serve(jr, theirs, decode_threads=2, encode_threads=2, lookahead=2)
    assert jstats.images == stats.images and sorted(_outputs(theirs)) == sorted(want)
    for name in want:
        got, theirs_u8 = imread(os.path.join(piped, name)), imread(os.path.join(theirs, name))
        if forward == "int8":
            np.testing.assert_array_equal(got, theirs_u8)
        else:
            _assert_u8_close(got, theirs_u8, forward)


def test_bad_file_is_skipped_and_no_native_codec_gives_the_same_pixels(tiny, tmp_path, monkeypatch, caplog):
    _, pr = _resolvers(tiny, "xla")
    bad = [("bad.png", b"\x89PNG\r\n\x1a\nnot a png at all")]
    native, fallback = _make_dir(tmp_path / "native", bad), _make_dir(tmp_path / "fallback", bad)
    logger = logging.getLogger("image_enhance_keras_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        assert serving.serve_directory(pr, native, decode_threads=2, encode_threads=2).images == 3
        monkeypatch.setattr(native_io, "available", lambda: False)
        monkeypatch.setattr(port_io, "_native", lambda: None)  # PIL decodes and encodes
        assert serving.serve_directory(pr, fallback, decode_threads=2, encode_threads=2).images == 3
    finally:
        logger.removeHandler(caplog.handler)
    assert sum("skipping undecodable" in r.getMessage() and "bad.png" in r.getMessage()
               for r in caplog.records) == 2
    got, want = _outputs(fallback), _outputs(native)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(imread(os.path.join(fallback, name)), imread(os.path.join(native, name)))


@pytest.fixture()
def cli_dirs(tiny, tmp_path, monkeypatch):
    """Both registries patched to the narrow model, its weights in an npz, one directory per run."""
    module, pn = tiny
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "tiny", None)
    monkeypatch.setattr(jax_engine, "get_model", lambda name, dtype=None, **kw: (module, jspec))
    pspec = port_zoo.ModelSpec("didbl", lambda **k: DifvdsrDouble(**NARROW), 4, False, "tiny", None)
    monkeypatch.setattr(port_engine, "get_model", lambda name, dtype=None, **kw: (pspec.make(), pspec))
    npz = tmp_path / "tiny.npz"
    np.savez(npz, **flatten_params(pn))
    base = _make_dir(tmp_path / "base")
    return lambda name: shutil.copytree(base, tmp_path / name), ["--weights", str(npz), "--mode", "fast"]


def test_save_intermediate_matches_jax_cli(cli_dirs):
    make, common = cli_dirs
    ours, theirs = make("port"), make("jax")
    assert port_main([str(ours), *common, "--save_intermediate", "--device", "cpu"]) == 0
    assert jax_main([str(theirs), *common, "--save_intermediate"]) == 0
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    inters = [n for n in names if "_intermediate_" in n and not n.startswith("old")]
    assert inters == ["a_intermediate_.png", "b_intermediate_.bmp", "c_intermediate_.png"]
    for n in inters:
        got = imread(str(ours / n))
        np.testing.assert_array_equal(got, imread(str(theirs / n)))
        src = imread(str(ours / n.replace("_intermediate_", "")))
        want = resize_pil_uint8(torch.from_numpy(src), (96, 96)).numpy().astype(np.uint8)
        np.testing.assert_array_equal(got, want)
    assert port_main([str(ours), *common, "--save_intermediate", "--device", "cpu"]) == 0
    assert sorted(os.listdir(ours)) == names  # a second run skips outputs and intermediates


def test_cli_pipeline_matches_serial(cli_dirs, caplog):
    make, common = cli_dirs
    serial, piped = make("serial"), make("piped")
    assert port_main([str(serial), *common, "--device", "cpu"]) == 0
    logger = logging.getLogger("image_enhance_keras_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        assert port_main([str(piped), *common, "--device", "cpu", "--pipeline", "--save_intermediate"]) == 0
    finally:
        logger.removeHandler(caplog.handler)
    assert any("no intermediate images will be written" in r.getMessage() for r in caplog.records)
    assert _outputs(piped) == _outputs(serial)
    assert not [n for n in os.listdir(piped) if "_intermediate_" in n and not n.startswith("old")]


def test_front_door_usage_matches_jax(capsys):
    from image_enhance_keras_tpu import __main__ as jax_front

    assert front._USAGE == jax_front._USAGE.replace("image_enhance_keras_tpu", "image_enhance_keras_tpu_torch")
    assert front.main([]) == 0 and front.main(["--help"]) == 0
    assert capsys.readouterr().out.count("commands:") == 2
    assert front.main(["nonsense"]) == 2
    assert "unknown command 'nonsense'" in capsys.readouterr().err


@pytest.mark.parametrize("cmd,module", [("upscale", "main_dirpath"), ("score", "scorpath"), ("learn", "learn"),
                                        ("prepare", "prepare_data")])
def test_front_door_dispatch(monkeypatch, cmd, module):
    import importlib

    mod = importlib.import_module(f"image_enhance_keras_tpu_torch.cli.{module}")
    seen = []
    monkeypatch.setattr(mod, "main", lambda argv: seen.append(argv) or 7)
    assert front.main([cmd, "x", "--flag"]) == 7
    assert seen == [["x", "--flag"]]


class _Repeat4:
    """A stand-in resolver: nearest-neighbour x4, no model."""

    def upscale(self, img):
        return np.repeat(np.repeat(img, 4, axis=0), 4, axis=1)


def test_pipeline_under_thread_stress(tmp_path):
    """More encoders than cores, a minimal lookahead and a short switch
    interval: every image is served once, under its serial name and bytes."""
    import sys

    d = tmp_path / "many"
    d.mkdir()
    for i in range(24):
        imwrite(str(d / f"{i:02d}.png"), np.random.default_rng(40 + i).integers(0, 256, (6, 5, 3), np.uint8))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stats = serving.serve_directory(_Repeat4(), str(d), decode_threads=3, encode_threads=2 * os.cpu_count() + 1,
                                        lookahead=1)
    finally:
        sys.setswitchinterval(interval)
    assert (stats.images, stats.out_pixels) == (24, 24 * 24 * 20)
    outs = _outputs(d)
    assert sorted(outs) == [f"{i:02d}_scaled(1x).png" for i in range(24)]
    for i in range(24):
        src = imread(str(d / f"{i:02d}.png"))
        np.testing.assert_array_equal(imread(str(d / f"{i:02d}_scaled(1x).png")), _Repeat4().upscale(src))
