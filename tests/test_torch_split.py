"""The port's split mode (whole-frame body, x4 tail over halo'd row stripes or
over a batch of shifted 2-D tiles) against its fast mode and the JAX package
on the CPU.

The narrow didbl (features 16, 2 + 1 + 1 blocks, flax init from key 3, as
``tests/test_torch_engine.py``), a seeded 20x28 image.  Split mode's halo
covers the tail's receptive field, so within each package split equals fast
byte for byte; the port's split then differs from JAX's split exactly where
the two fast modes differ: not at all in float32 here, 1 level on under 3%
of the values in the bf16 and mixed profiles (whose bf16 roundings turn a
change of summation order into flips; ``tests/test_torch_mixed.py``).  The
int8 forward is bit-equal to JAX's (plain int8 blocks equal JAX's
interpret-mode kernels), and within JAX's own bound of its fast mode (3
levels on under 5% of values, ``tests/test_split_mode.py``).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.tiling import tiles as jax_tiles
from image_enhance_keras_tpu_torch.data.io import _bmp_write, imread
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.weights import flatten_params
from image_enhance_keras_tpu_torch.tiling import tiles

NARROW = dict(features=16, n_body53=2, n_light=1, n_tail53=1)
#: port vs JAX, uint8: (max levels, share of values) per profile
U8_BOUND = {"float32": (0, 0.0), "bfloat16": (1, 0.03), "mixed": (1, 0.03), "mixed-tail": (1, 0.03)}
INT8_MAX_DIFF, INT8_MAX_FRAC = 3, 0.05
PROFILES = {"float32": {}, "bfloat16": dict(dtype="bfloat16"), "mixed": dict(mixed=True),
            "mixed-tail": dict(mixed="tail")}
#: split layouts on a 20x28 image (halo 2): stripes of 4 rows; 2-D tiles of 8 (3x4 =
#: 12 tiles, chunk 8: a remainder); 2-D tiles of 8 x 16 (3x2 = 6, chunk 3: none)
LAYOUTS = {"stripes": dict(split_tile=4), "tiles": dict(split_tile=8, split_tile_w=8),
           "tiles_dividing": dict(split_tile=8, split_tile_w=16, chunk=3)}


@pytest.mark.parametrize("total,t,halo,scale", [(20, 8, 2, 4), (28, 8, 2, 4), (7, 16, 3, 4), (64, 16, 3, 4),
                                                (37, 5, 3, 2), (130, 128, 3, 4)])
def test_shifted_grid_matches_jax(total, t, halo, scale):
    assert tiles.shift_grid_axis(total, t, halo) == jax_tiles.shift_grid_axis(total, t, halo)
    np.testing.assert_array_equal(tiles.shifted_extract_indices(total, t, halo),
                                  jax_tiles.shifted_extract_indices(total, t, halo))
    np.testing.assert_array_equal(tiles.shifted_stitch_indices(total, t, halo, scale),
                                  jax_tiles.shifted_stitch_indices(total, t, halo, scale))


@pytest.mark.parametrize("hw,t", [((20, 28), (8, 8)), ((13, 40), (4, 16))])
def test_tiles_2d_gather_and_scatter_match_jax(hw, t):
    halo, scale = 2, 4
    (T_r, sr, _), (T_c, sc, _) = (tiles.shift_grid_axis(n, k, halo) for n, k in zip(hw, t))
    ex = [tiles.shifted_extract_indices(n, k, halo) for n, k in zip(hw, t)]
    st = [tiles.shifted_stitch_indices(n, k, halo, scale) for n, k in zip(hw, t)]
    x = np.random.default_rng(0).normal(size=(*hw, 5)).astype(np.float32)
    got = tiles.gather_tiles_2d(torch.from_numpy(x), *map(torch.from_numpy, ex), len(sr), len(sc), T_r, T_c)
    want = jax_tiles.gather_tiles_2d(jnp.asarray(x), *map(jnp.asarray, ex), len(sr), len(sc), T_r, T_c)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y = np.random.default_rng(1).normal(size=(len(sr) * len(sc), T_r * scale, T_c * scale, 3)).astype(np.float32)
    got = tiles.scatter_tiles_2d(torch.from_numpy(y), *map(torch.from_numpy, st), len(sr), len(sc), T_r, T_c, scale)
    want = jax_tiles.scatter_tiles_2d(jnp.asarray(y), *map(jnp.asarray, st), len(sr), len(sc), T_r, T_c, scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def narrow():
    params = FlaxDidbl(**NARROW).init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))["params"]
    img = np.random.default_rng(11).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    return jax.tree_util.tree_map(np.asarray, params), img


@pytest.fixture()
def patched(monkeypatch):
    """Both registries build the narrow didbl in the asked profile."""
    jspec = jax_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    pspec = port_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    monkeypatch.setattr(jax_engine, "get_model",
                        lambda name, dtype=None, **kw: (FlaxDidbl(dtype=dtype, **NARROW, **kw), jspec))
    monkeypatch.setattr(port_engine, "get_model",
                        lambda name, dtype=None, **kw: (DifvdsrDouble(dtype=dtype, **NARROW, **kw), pspec))


def _pair(pn, chunk=None, **kw):
    jkw = dict(kw)
    if jkw.get("dtype") == "bfloat16":
        jkw["dtype"] = jnp.bfloat16
    jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn), **jkw)
    pr = port_engine.SuperResolver(params=pn, device="cpu", **kw)
    if chunk:
        jr.split2d_chunk = pr.split2d_chunk = chunk
    return jr, pr


def _u8_gap(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("profile", list(PROFILES))
def test_split_matches_fast_and_jax(narrow, patched, profile, layout):
    pn, img = narrow
    jf, pf = _pair(pn, mode="fast", **PROFILES[profile])
    js, ps = _pair(pn, mode="split", **LAYOUTS[layout], **PROFILES[profile])
    fast_j, fast_p = np.asarray(jf.upscale(img)), pf.upscale(img)
    split_j, split_p = np.asarray(js.upscale(img)), ps.upscale(img)
    assert split_p.shape == (80, 112, 3)
    np.testing.assert_array_equal(split_p, fast_p)  # the port's promise
    np.testing.assert_array_equal(split_j, fast_j)  # JAX's
    dmax, frac = _u8_gap(split_p, split_j)
    print(f"split {layout} {profile}: port vs JAX uint8 max diff {dmax}, {frac:.3g} of values differ")
    bmax, bfrac = U8_BOUND[profile]
    assert dmax <= bmax and frac <= bfrac


@pytest.mark.parametrize("layout", ["tiles", "tiles_dividing"])
def test_split2d_chunk_warning_matches_jax(narrow, patched, caplog, layout):
    """The same warning, word for word, when the chunk leaves a remainder batch; none otherwise."""
    pn, img = narrow
    jr, pr = _pair(pn, mode="split", **LAYOUTS[layout])
    loggers = [logging.getLogger(name) for name in ("image_enhance_keras_tpu", "image_enhance_keras_tpu_torch")]
    for logger in loggers:
        logger.addHandler(caplog.handler)
    try:
        jr.upscale(img)
        pr.upscale(img)
    finally:
        for logger in loggers:
            logger.removeHandler(caplog.handler)
    msgs = {r.name.split(".")[0]: r.getMessage() for r in caplog.records if "split2d" in r.getMessage()}
    if layout == "tiles":
        assert msgs["image_enhance_keras_tpu_torch"] == msgs["image_enhance_keras_tpu"]
        assert "chunk 8 does not divide the 3x4=12-tile batch (remainder 4)" in msgs["image_enhance_keras_tpu"]
    else:
        assert not msgs


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


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_split_pallas_int8_matches_jax(narrow, patched, int8_qparams, layout):
    pn, img = narrow
    jf, pf = _pair(pn, mode="fast", forward="pallas_int8")
    js, ps = _pair(pn, mode="split", forward="pallas_int8", **LAYOUTS[layout])
    for r, qp in ((jf, int8_qparams[0]), (js, int8_qparams[0]), (pf, int8_qparams[1]), (ps, int8_qparams[1])):
        r._qparams = qp
    split_p, split_j = ps.upscale(img), np.asarray(js.upscale(img))
    np.testing.assert_array_equal(split_p, split_j)
    dmax, frac = _u8_gap(split_p, pf.upscale(img))
    print(f"split {layout} pallas_int8 vs fast: uint8 max diff {dmax}, {frac:.3g} of values differ")
    assert dmax <= INT8_MAX_DIFF and frac < INT8_MAX_FRAC


@pytest.mark.parametrize("forward", ["pallas", "pallas_chain"])
def test_split_rejects_pallas_forwards_as_jax_does(narrow, patched, forward):
    pn, img = narrow
    jr, pr = _pair(pn, mode="split", forward=forward)
    with pytest.raises(ValueError) as want:
        jr.upscale(img)
    with pytest.raises(ValueError) as got:
        pr.upscale(img)
    assert str(got.value) == str(want.value)
    assert str(got.value) == f"mode='split' supports the xla/int8/pallas_int8 forwards, not {forward!r}"


def test_split_int8_forward_not_ported(narrow, patched, monkeypatch):
    """Split mode on ``--forward int8`` runs (tests/test_torch_int8_xla.py),
    and so does its tail under ``IEK_INT8_UPMM=1`` (the x4 as two dense
    matmuls), once refused here: byte-equal to fast mode under the knob."""
    pn, img = narrow
    monkeypatch.setenv("IEK_INT8_UPMM", "1")
    out = {}
    for mode in ("split", "fast"):
        r = port_engine.SuperResolver(params=pn, mode=mode, forward="int8", device="cpu")
        r.int8_calib = "synthetic"
        out[mode] = r.upscale(img)
    np.testing.assert_array_equal(out["split"], out["fast"])


def test_fast_falls_back_to_patch_above_fast_max_pixels(narrow, patched, caplog):
    pn, img = narrow
    _, pr = _pair(pn, mode="fast", fast_max_pixels=100, patch=24, step=16)
    _, pp = _pair(pn, mode="patch", patch=24, step=16)
    logger = logging.getLogger("image_enhance_keras_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        got = pr.upscale(img)
    finally:
        logger.removeHandler(caplog.handler)
    np.testing.assert_array_equal(got, pp.upscale(img))
    assert any("exceeds fast_max_pixels=100" in r.getMessage() and "use mode='split'" in r.getMessage()
               for r in caplog.records)


@pytest.mark.parametrize("argv", [
    ["--split-tile", "4"], ["--split-tile", "8", "--split-tile-w", "8"],
    ["--dtype", "bfloat16", "--split-tile", "8", "--split-tile-w", "16"],
])
def test_cli_split_matches_jax_cli(narrow, patched, tmp_path, argv):
    from image_enhance_keras_tpu.cli.main_dirpath import main as jax_main
    from image_enhance_keras_tpu_torch.cli.main_dirpath import main as port_main

    pn, img = narrow
    npz = tmp_path / "narrow.npz"
    np.savez(npz, **flatten_params(pn))
    outs = {}
    for name, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"]),
                              ("port_fast", port_main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        _bmp_write(str(d / "img.bmp"), img)
        mode = ["--mode", "fast"] if name == "port_fast" else ["--mode", "split", *argv]
        dtype = [a for a in argv if a in ("--dtype", "bfloat16")]
        assert main([str(d), "--weights", str(npz), *(mode if name != "port_fast" else mode + dtype), *extra]) == 0
        outs[name] = imread(str(d / "img_scaled(1x).bmp"))
    np.testing.assert_array_equal(outs["port"], outs["port_fast"])
    dmax, frac = _u8_gap(outs["port"], outs["jax"])
    print(f"main_dirpath --mode split {' '.join(argv)}: port vs JAX uint8 max diff {dmax}, {frac:.3g} differ")
    bmax, bfrac = U8_BOUND["bfloat16" if "bfloat16" in argv else "float32"]
    assert dmax <= bmax and frac <= bfrac
