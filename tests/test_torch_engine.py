"""Port's engine and main_dirpath CLI against the JAX engine and CLI on the CPU.

A 20x28 seeded BMP, tiles of 24 at step 16, the narrow didbl (features 16,
2 + 1 + 1 blocks) with the same weights in both packages.  The uint8
outputs come from float32 forwards that sum in other orders, so a pixel
sitting on a rounding boundary may flip: at most 0.1% of the values may
differ, each by at most 1.
"""

import logging
import os

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
from image_enhance_keras_tpu.tiling import tiles as jax_tiles
from image_enhance_keras_tpu_torch.cli.main_dirpath import main as port_main
from image_enhance_keras_tpu_torch.data.io import _bmp_read, _bmp_write, imread
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.weights import flatten_params
from image_enhance_keras_tpu_torch.tiling import tiles

NARROW = dict(features=16, n_body53=2, n_light=1, n_tail53=1)
GEOM = dict(patch=24, step=16)
MAX_DIFF, MAX_FRAC = 1, 1e-3


def _assert_u8_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= MAX_DIFF and (d > 0).mean() <= MAX_FRAC, (d.max(), (d > 0).mean())


@pytest.fixture(scope="module")
def tiny():
    """Narrow flax module, its params as numpy, and a seeded 20x28 image."""
    module = FlaxDidbl(**NARROW)
    params = module.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))["params"]
    img = np.random.default_rng(11).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    return module, jax.tree_util.tree_map(np.asarray, params), img


def _resolvers(tiny, **kw):
    module, pn, _ = tiny
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "tiny", None)
    jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn),
                                  module_and_spec=(module, jspec), **GEOM, **kw)
    pmod = DifvdsrDouble(**NARROW)
    pspec = port_zoo.ModelSpec("didbl", lambda **k: pmod, 4, False, "tiny", None)
    pr = port_engine.SuperResolver(params=pn, module_and_spec=(pmod, pspec), device="cpu", **GEOM, **kw)
    return jr, pr


@pytest.mark.parametrize("mode", ["patch", "fast"])
def test_engine_matches_jax(tiny, mode):
    jr, pr = _resolvers(tiny, mode=mode)
    img = tiny[2]
    want = np.asarray(jr.upscale(img))
    got = pr.upscale(img)
    assert got.shape == (80, 112, 3)
    _assert_u8_close(got, want)


def test_engine_pallas_forward_matches_module_forward(tiny):
    _, pr = _resolvers(tiny)
    _, pk = _resolvers(tiny, forward="pallas")
    _assert_u8_close(pk.upscale(tiny[2]), pr.upscale(tiny[2]))


@pytest.mark.parametrize("mode", ["patch", "fast"])
def test_engine_pallas_chain_matches_jax(tiny, mode):
    jr, pr = _resolvers(tiny, mode=mode, forward="pallas_chain")
    img = tiny[2]
    got = pr.upscale(img)
    assert got.shape == (80, 112, 3)
    _assert_u8_close(got, np.asarray(jr.upscale(img)))


def test_round_modes():
    r = port_engine.SuperResolver.__new__(port_engine.SuperResolver)
    y = torch.tensor([-3.0, 0.5, 1.5, 2.5, 254.5, 254.7, 300.0])
    r.round_mode = "round"
    assert r._finalize_u8(y).tolist() == [0, 0, 2, 2, 254, 255, 255]  # half to even
    r.round_mode = "trunc"
    assert r._finalize_u8(y).tolist() == [0, 0, 1, 2, 254, 254, 255]


@pytest.fixture()
def cli_setup(tiny, tmp_path, monkeypatch):
    """Both registries patched to the narrow model; its weights in an npz."""
    module, pn, img = tiny
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "tiny", None)
    monkeypatch.setattr(jax_engine, "get_model", lambda name, dtype=None, **kw: (module, jspec))
    pspec = port_zoo.ModelSpec("didbl", lambda **k: DifvdsrDouble(**NARROW), 4, False, "tiny", None)
    monkeypatch.setattr(port_engine, "get_model", lambda name, dtype=None, **kw: (pspec.make(), pspec))
    npz = tmp_path / "tiny.npz"
    np.savez(npz, **flatten_params(pn))
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        _bmp_write(str(dirs[name] / "img.bmp"), img)
    return dirs, str(npz)


def test_cli_pallas_matches_jax_cli(cli_setup):
    dirs, npz = cli_setup
    common = ["--weights", npz, "--forward", "pallas", "--patch_size", "24", "--step", "16"]
    assert jax_main([str(dirs["jax"]), *common]) == 0
    assert port_main([str(dirs["port"]), *common, "--device", "cpu"]) == 0
    out = dirs["port"] / "img_scaled(1x).bmp"
    assert out.exists()  # the <stem>_scaled(1x)<ext> contract
    got = imread(str(out))
    assert got.shape == (80, 112, 3)
    _assert_u8_close(got, imread(str(dirs["jax"] / "img_scaled(1x).bmp")))
    # a rerun skips the outputs of the first run
    assert port_main([str(dirs["port"]), *common, "--device", "cpu"]) == 0
    assert sorted(os.listdir(dirs["port"])) == ["img.bmp", "img_scaled(1x).bmp"]


def test_cli_pallas_chain_matches_jax_cli(cli_setup):
    dirs, npz = cli_setup
    common = ["--weights", npz, "--forward", "pallas_chain", "--patch_size", "24", "--step", "16"]
    assert jax_main([str(dirs["jax"]), *common]) == 0
    assert port_main([str(dirs["port"]), *common, "--device", "cpu"]) == 0
    got = imread(str(dirs["port"] / "img_scaled(1x).bmp"))
    assert got.shape == (80, 112, 3)
    _assert_u8_close(got, imread(str(dirs["jax"] / "img_scaled(1x).bmp")))


def test_cli_defaults_to_cuda(cli_setup, monkeypatch):
    dirs, npz = cli_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main([str(dirs["port"]), "--weights", npz])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_engine.SuperResolver(weights=npz)


#: the zoo at narrow widths, for the CLIs' random-init runs
ZOO_NARROW = {
    "didbl": NARROW, "didbl_subpixel": NARROW, "difv4": dict(features=8, n_head=1, n_mid=1, n_tail=1),
    "difv4_x2": dict(features=8, n_head=1, n_mid=1, n_tail=1), "difvdsr": dict(features=8, n_blocks=1),
}


def _sharded_cli_runs(tmp_path, monkeypatch, argv):
    """Both CLIs on ``argv`` (narrow models, ``--weights none``) over an
    empty directory: each exits 0, the port through a ShardedResolver over
    an N-entry CPU mesh (``--devices N``)."""
    import image_enhance_keras_tpu_torch.parallel as port_parallel

    for mod in (jax_engine, port_engine):
        monkeypatch.setattr(mod, "get_model", lambda name, dtype=None, _o=mod.get_model, **kw: _o(
            name, dtype=dtype, **{**ZOO_NARROW[name], **kw}))
    argv = [*argv, "--weights", "none"]
    built = []

    class Spy(port_parallel.ShardedResolver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(port_parallel, "ShardedResolver", Spy)
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    assert jax_main([str(tmp_path / "jax"), *argv]) == 0
    assert port_main([str(tmp_path / "port"), "--device", "cpu", *argv]) == 0
    n = int(argv[argv.index("--devices") + 1])
    assert len(built) == 1 and built[0].n_devices == n and built[0].mesh.size == n
    assert built[0].devices == [torch.device("cpu")] * n


# --devices was refused here before the scale-out slice; each argv is now
# accepted by both CLIs, as JAX's is
@pytest.mark.parametrize("argv", [
    ["--mode", "fast", "--devices", "8"],
    ["--forward", "int8", "--model", "difvdsr", "--save_intermediate", "--devices", "2"],
    ["--model", "didbl_subpixel", "--pipeline", "--devices", "4"], ["--model", "difv4", "--devices", "2"],
    ["--forward", "pallas_chain", "--internal-learn", "2", "--save_intermediate", "--devices", "3"],
    ["--devices", "2"], ["--save_intermediate", "--devices", "2"], ["--pipeline", "--devices", "2"],
])
def test_cli_rejects_unported_flags(tmp_path, monkeypatch, argv):
    _sharded_cli_runs(tmp_path, monkeypatch, argv)


@pytest.mark.parametrize("hw", [(20, 28), (64, 64), (37, 101)])
def test_tiling_matches_jax(hw):
    plan = tiles.plan_tiles(*hw, patch=24, step=16, scale=4, crop=8)
    jplan = jax_tiles.plan_tiles(*hw, patch=24, step=16, scale=4, crop=8)
    assert tuple(getattr(plan, f) for f in ("padded_h", "padded_w", "cnt_h", "cnt_w")) == tuple(
        getattr(jplan, f) for f in ("padded_h", "padded_w", "cnt_h", "cnt_w"))
    img = np.random.default_rng(1).random((*hw, 3)).astype(np.float32)
    t = tiles.extract_tiles(tiles.pad_to_plan(torch.from_numpy(img), plan), plan)
    jt = jax_tiles.extract_tiles(jax_tiles.pad_to_plan(jnp.asarray(img), jplan), jplan)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    up = np.random.default_rng(2).random((plan.n_tiles, 96, 96, 3)).astype(np.float32)
    s = tiles.crop_output(tiles.stitch_tiles(torch.from_numpy(up), plan), plan)
    js = jax_tiles.crop_output(jax_tiles.stitch_tiles(jnp.asarray(up), jplan), jplan)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_bmp_codec_roundtrip(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (7, 13, 3), dtype=np.uint8)
    _bmp_write(str(tmp_path / "a.bmp"), img)
    np.testing.assert_array_equal(_bmp_read(str(tmp_path / "a.bmp")), img)


def test_output_name_contract():
    assert port_engine.output_name("/d/a.png") == "/d/a_scaled(1x).png"
    assert port_engine.output_name("b.bmp", "x", 4) == "b_x(4x).bmp"


# -- --forward pallas_int8 -------------------------------------------------
# Two int8 forwards that round bf16 activations differently may flip an int8
# code and move a pixel by a few levels: the bound JAX holds between two of
# its own int8 forwards (tests/test_split_mode.py:97-98).
INT8_MAX_DIFF, INT8_MAX_FRAC = 3, 0.05


def _assert_u8_int8_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"uint8: max diff {d.max()}, differing fraction {(d > 0).mean():.3g}")
    assert d.max() <= INT8_MAX_DIFF and (d > 0).mean() < INT8_MAX_FRAC, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("mode", ["patch", "fast"])
def test_engine_pallas_int8_matches_jax(tiny, mode):
    jr, pr = _resolvers(tiny, mode=mode, forward="pallas_int8")
    img = tiny[2]
    got = pr.upscale(img)
    assert got.shape == (80, 112, 3)
    _assert_u8_int8_close(got, np.asarray(jr.upscale(img)))
    assert pr._qparams["body53_0"]["conv_a1"]["q"].dtype == torch.int8


@pytest.mark.parametrize("source", ["photos", "procedural", "synthetic", "first_frame"])
def test_calibration_source_matches_jax(tiny, monkeypatch, caplog, source):
    """Each calibration source, with its fallbacks, gives JAX's calibration batch."""
    from image_enhance_keras_tpu.data import pipeline as jax_pipeline
    from image_enhance_keras_tpu_torch.data import pipeline

    jr, pr = _resolvers(tiny, forward="pallas_int8")
    img = tiny[2]
    if source == "photos":
        want = jr._calib_from_arrays(jax_pipeline.builtin_photos(), 4)
    elif source == "procedural":
        monkeypatch.setattr(pipeline, "builtin_photos", lambda: [])
        want = jr._calib_from_arrays(jax_pipeline.rich_synthetic_images(8, 256, seed=17), 4)
    elif source == "synthetic":
        pr.int8_calib = "synthetic"
        want = np.stack(jax_pipeline.synthetic_images(4, 128)).astype(np.float32) / 255.0
    else:
        pr.int8_calib = jr.int8_calib = "first_frame"
        jr._maybe_calibrate_int8(img)
        pr._maybe_calibrate_int8(img)
        want = jr._calib_x
    logger = logging.getLogger("image_enhance_keras_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        got = pr._calibration_input()
    finally:
        logger.removeHandler(caplog.handler)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert any(r.getMessage().startswith("int8 calibration:") for r in caplog.records)


@pytest.mark.parametrize("mode", ["patch", "fast"])
def test_cli_pallas_int8_matches_jax_cli_and_honours_calib_dir(cli_setup, tmp_path, monkeypatch, mode):
    dirs, npz = cli_setup
    calib = tmp_path / "calib"
    calib.mkdir()
    _bmp_write(str(calib / "frame.bmp"),
               np.random.default_rng(12).integers(0, 256, (72, 88, 3), dtype=np.uint8))
    seen = []
    orig = port_engine.SuperResolver._calib_from_images
    monkeypatch.setattr(port_engine.SuperResolver, "_calib_from_images",
                        lambda self: seen.append(orig(self)) or seen[-1])
    common = ["--weights", npz, "--forward", "pallas_int8", "--mode", mode, "--patch_size", "24",
              "--step", "16", "--int8-calib-dir", str(calib)]
    assert jax_main([str(dirs["jax"]), *common]) == 0
    assert port_main([str(dirs["port"]), *common, "--device", "cpu"]) == 0
    assert len(seen) == 1 and tuple(seen[0].shape) == (1, 18, 18, 3)  # 72x88 / 4, central square
    got = imread(str(dirs["port"] / "img_scaled(1x).bmp"))
    _assert_u8_int8_close(got, imread(str(dirs["jax"] / "img_scaled(1x).bmp")))


@pytest.mark.parametrize("argv", [
    ["--forward", "int8", "--devices", "2"],
    ["--forward", "int8", "--internal-learn", "1", "--pipeline", "--devices", "2"],
    ["--forward", "int8", "--model", "didbl_subpixel", "--internal-learn-lr", "1e-4", "--save_intermediate",
     "--devices", "2"],
    ["--forward", "int8", "--int8-acc", "s32", "--model", "difv4", "--pipeline", "--devices", "8"],
])
def test_cli_rejects_other_int8_options(tmp_path, monkeypatch, argv):
    _sharded_cli_runs(tmp_path, monkeypatch, argv)
