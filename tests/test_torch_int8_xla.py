"""The port's ``--forward int8`` (the XLA int8 serving profile) against the JAX package on the CPU.

JAX runs these blocks as XLA convolutions; the port runs them on the
per-channel s8 kernels of ``ops/cuda/int8_xla.py`` (X1-X3), whose plain
versions run here.  Both sides use JAX's quantized tree (carried over with
``params_from_numpy``), so they quantize with the same codes; the port's
own calibration is held to JAX's in tests/test_torch_int8_calib.py.

The reference is JAX run op by op (``jax.disable_jit()``): the accumulator
rounded by ``IEK_INT8_ACC`` (bf16: the s32 sum to float32, then to bf16),
every product and add of the dequant and the combine rounded on its own,
and the per-sample scales divided by 127.0.  Against it the port is bit-
(float) or byte- (uint8) equal.  Jitted, XLA on the CPU folds the
accumulator's conversion into the conv and fuses the dequant into FMAs: on
the 20x28 test image 15-18% of the jitted engine's uint8 values differ from
the op-by-op ones, by up to 2 levels, under the bf16 accumulator, and none
under s32.  The tests state that distance; ROADMAP.md §3 records it as a
standing difference.  XLA sums the ``f32`` and ``bf16`` modes in float32,
exact only below 2^24; the port sums exactly, so the ``f32`` cases assert
that their sums stay below it.

The narrow didbl (features 16, 2 + 1 + 1 blocks) and one C = 128 block at
12x12.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu.cli.main_dirpath import main as jax_main
from image_enhance_keras_tpu.cli.scorpath import main as jax_scorpath
from image_enhance_keras_tpu.models import didbl_pallas as jax_dp
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu_torch.cli.main_dirpath import main as port_main
from image_enhance_keras_tpu_torch.cli.scorpath import main as port_scorpath
from image_enhance_keras_tpu_torch.data.io import _bmp_write, imread
from image_enhance_keras_tpu_torch.models import didbl_pallas as dp
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models import zoo_int8
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.weights import flatten_params, params_from_numpy
from image_enhance_keras_tpu_torch.ops.cuda import int8_xla

NARROW = dict(features=16, n_body53=2, n_light=1, n_tail53=1)
BLOCKS = dict(n_body53=2, n_light=1, n_tail53=1)
ACCS = ["bf16", "s32", "f32"]
#: the int8 uint8 bound JAX holds between two of its own int8 forwards
#: (tests/test_split_mode.py): here the level part, against the jitted engine
INT8_MAX_DIFF = 3


def _np(t):
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jax.Array) else t.float().numpy()


@pytest.fixture(scope="module")
def narrow():
    """Narrow flax params (numpy), JAX's calibrated int8 tree (as JAX and as the port's tensors)."""
    module = FlaxDidbl(**NARROW)
    params = module.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))["params"]
    calib = np.random.default_rng(9).random((2, 20, 20, 3)).astype(np.float32)
    with jax.disable_jit():
        jq = jax_dp.quantize_didbl_params(params, calib_x=jnp.asarray(calib), **BLOCKS)
    return module, jax.tree_util.tree_map(np.asarray, params), jq, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jq))


def _bf16_input(shape, seed):
    x = np.random.default_rng(seed).random(shape).astype(np.float32) * 1.5
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _exact_sums(q, w):
    """max |s32 sum| of a conv of int8 codes, exactly (float64)."""
    q, w = np.asarray(q, np.float64), np.asarray(w, np.float64)
    y = torch.nn.functional.conv2d(torch.from_numpy(q).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1),
                                   padding=w.shape[0] // 2)
    return float(y.abs().max())


def _max_sums(x, p):
    """The largest |sum| over a static block's convs (the codes from JAX)."""
    sc = p["actc"]
    with jax.disable_jit():
        xq = jax_dp._quant_c(x, sc["x"])
        out = []
        for c1, c2, s in (("conv_a1", "conv_a2", "a"), ("conv_b1", "conv_b2", "b"), ("conv_a", "conv_b", "t")):
            if c1 not in p:
                continue
            out.append(_exact_sums(xq, p[c1]["qf"]))
            t = jnp.maximum(jax_dp._deqf(jax_dp._qconv_xla(xq, p[c1]["qf"]), p[c1]), 0.0)
            out.append(_exact_sums(jax_dp._quant_c(t, sc[s]), p[c2]["qf"]))
    return max(out)


# -- the blocks -----------------------------------------------------------------

BLOCK_FNS = {"light53": (jax_dp._light53_i8_xla, dp._light53_i8_xla, "body53_0"),
             "light": (jax_dp._light_i8_xla, dp._light_i8_xla, "light_0"),
             "light53_dyn": (jax_dp._light53_i8_xla_dyn, dp._light53_i8_xla_dyn, "tail53_0")}


@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("which", sorted(BLOCK_FNS))
def test_blocks_bit_equal_eager_jax(narrow, monkeypatch, which, acc):
    """X1 / X2 / X3's plain versions on JAX's quantized block, 2 x 12x14 x 16."""
    _, _, jq, qp = narrow
    jfn, pfn, name = BLOCK_FNS[which]
    monkeypatch.setenv("IEK_INT8_ACC", acc)
    xj, xt = _bf16_input((2, 12, 14, 16), 5)
    with jax.disable_jit():
        want = jfn(xj, jq[name])
    got = pfn(xt, qp[name])
    assert got.dtype == torch.bfloat16 and got.shape == (2, 12, 14, 16)
    if acc == "f32" and which != "light53_dyn":
        assert _max_sums(xj, jq[name]) < 2 ** 24  # XLA's float32 sums are exact here
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("acc", ["bf16", "s32"])
@pytest.mark.parametrize("which", ["light53", "light53_dyn"])
def test_block_at_full_width_bit_equal_eager_jax(monkeypatch, which, acc):
    """One C = 128 Light53 block at 12x12, its weights quantized per channel
    and its scales folded as ``quantize_didbl_params`` does."""
    rng = np.random.default_rng(21)
    c = 128
    blk = {cv: {"kernel": jnp.asarray(rng.normal(size=(k, k, c, c)).astype(np.float32) * (2.0 / (k * k * c)) ** 0.5),
                "bias": jnp.asarray(rng.normal(size=c).astype(np.float32) * 0.02)}
           for cv, k in (("conv_a1", 3), ("conv_a2", 5), ("conv_b1", 5), ("conv_b2", 3))}
    params = {"level1": None, "out": None, "body53_0": blk}
    x = rng.random((1, 12, 12, c)).astype(np.float32)
    scales = {"body53_0": {"x": jnp.asarray(np.abs(x).max(axis=(0, 1, 2)) / 127 + 1e-3),
                           "a": jnp.asarray(0.01 + 0.02 * rng.random(c).astype(np.float32)),
                           "b": jnp.asarray(0.01 + 0.02 * rng.random(c).astype(np.float32))}}
    monkeypatch.setattr(jax_dp, "calibrate_didbl_act_scales", lambda *a, **k: scales)
    jq = jax_dp.quantize_didbl_params(params, n_body53=1, n_light=0, n_tail53=0, calib_x=jnp.zeros((1, 4, 4, 3)))
    qp = params_from_numpy(jax.tree_util.tree_map(np.asarray, {"body53_0": jq["body53_0"]}))
    monkeypatch.setenv("IEK_INT8_ACC", acc)
    jfn, pfn, _ = BLOCK_FNS[which]
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    with jax.disable_jit():
        want = jfn(xj, jq["body53_0"])
    got = pfn(torch.from_numpy(x).to(torch.bfloat16), qp["body53_0"])
    np.testing.assert_array_equal(_np(got), _np(want))


def _full_width_light(monkeypatch):
    """One C = 128 Light block (JAX's quantized tree and the port's) and a 12x12 input."""
    rng = np.random.default_rng(22)
    c = 128
    blk = {cv: {"kernel": jnp.asarray(rng.normal(size=(3, 3, c, c)).astype(np.float32) * (2.0 / (9 * c)) ** 0.5),
                "bias": jnp.asarray(rng.normal(size=c).astype(np.float32) * 0.02)} for cv in ("conv_a", "conv_b")}
    x = rng.random((1, 12, 12, c)).astype(np.float32)
    scales = {"light_0": {"x": jnp.asarray(np.abs(x).max(axis=(0, 1, 2)) / 127 + 1e-3),
                          "t": jnp.asarray(0.01 + 0.02 * rng.random(c).astype(np.float32))}}
    monkeypatch.setattr(jax_dp, "calibrate_didbl_act_scales", lambda *a, **k: scales)
    jq = jax_dp.quantize_didbl_params({"level1": None, "out": None, "light_0": blk}, n_body53=0, n_light=1,
                                      n_tail53=0, calib_x=jnp.zeros((1, 4, 4, 3)))
    return jq["light_0"], params_from_numpy(jax.tree_util.tree_map(np.asarray, {"light_0": jq["light_0"]}))["light_0"], x


@pytest.mark.parametrize("emit", ["wide", "s8"])
@pytest.mark.parametrize("acc", ["bf16", "s32"])
@pytest.mark.parametrize("width", ["narrow", "full"])
def test_x2_on_x4_block_forms_bit_equal(narrow, monkeypatch, width, acc, emit):
    """X2 is X4's codes form (from bf16 x, relu, at s_x then s_t) followed by
    its LightBlock form, at the same rounding points (the CUDA launches of
    both, and X2's own two launches, run these forms).  Their plain
    composition equals X2's plain version and eager JAX's ``_light_i8_xla``
    bit for bit, under both accumulators and both emissions (IEK_INT8_EMIT),
    at features 16 and 128."""
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv

    monkeypatch.setenv("IEK_INT8_ACC", acc)
    monkeypatch.setenv("IEK_INT8_EMIT", emit)
    if width == "narrow":
        _, _, jq, qp = narrow
        jp, tp = jq["light_0"], qp["light_0"]
        x = np.random.default_rng(6).random((2, 12, 14, 16)).astype(np.float32) * 1.5
    else:
        jp, tp, x = _full_width_light(monkeypatch)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    a, b, sc = tp["conv_a"], tp["conv_b"], tp["actc"]
    tq = int8_conv.int8_conv3_codes_plain(xt, a["qf"], a["sf"], a["bias"], sc["x"], sc["t"], acc, act="relu")
    got = int8_conv.int8_conv3_light_plain(tq, b["qf"], b["sf"], b["bias"], xt, acc)
    plain = int8_xla.light_int8_xla_plain(xt, a["qf"], a["sf"], a["bias"], b["qf"], b["sf"], b["bias"],
                                          torch.stack([sc["x"], sc["t"]]), acc, emit == "s8")
    assert got.dtype == torch.bfloat16 and torch.equal(got, plain)
    with jax.disable_jit():
        want = jax_dp._light_i8_xla(jnp.asarray(x).astype(jnp.bfloat16), jp)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("n_bands", [1, 3])
def test_x3_requant_pass_and_code_convs_bit_equal_plain(acc, n_bands):
    """X3 as its kernels split it, whole (one band) and banded: the first
    convs per band over their own rows, the branch abs-maxes reduced over the
    frame's bands, the requantization pass into int8 codes, the second convs
    over the codes; bit-equal to today's ``light53_int8_xla_dyn_plain``."""
    from image_enhance_keras_tpu_torch.ops.cuda.int8_blocks import quantize_weights_per_channel

    rng = np.random.default_rng(n_bands + len(acc))
    c, halo = 32, 3  # Light53's radius: a 3x3 then a 5x5 conv, or a 5x5 then a 3x3

    def conv(k):
        q, sw = quantize_weights_per_channel(torch.from_numpy(
            (rng.normal(size=(k, k, c, c)) * (2.0 / (k * k * c)) ** 0.5).astype(np.float32)))
        return [q, sw, torch.from_numpy((rng.normal(size=c) * 0.02).astype(np.float32))]

    wa1, wa2, wb1, wb2 = conv(3), conv(5), conv(5), conv(3)
    x = torch.from_numpy((rng.normal(size=(2, 13, 10, c)) * 2).astype(np.float32)).to(torch.bfloat16)
    want = int8_xla.light53_int8_xla_dyn_plain(x, *wa1, *wa2, *wb1, *wb2, acc=acc)
    cuts = np.linspace(0, x.shape[1], n_bands + 1).astype(int)
    bands, firsts = [], []
    for y0, y1 in zip(cuts[:-1], cuts[1:]):
        lo, hi = max(0, y0 - halo), min(x.shape[1], y1 + halo)
        xb = x[:, lo:hi]
        bands.append((xb, y0 - lo, y1 - lo))
        firsts.append(int8_xla.light53_int8_xla_dyn_first_plain(xb, *wa1, *wb1, int8_xla.sample_absmax(x), acc,
                                                                (y0 - lo, y1 - lo, 0, x.shape[2])))
    amax_ab = torch.stack([f[2] for f in firsts]).amax(dim=0)
    got = []
    for (xb, r0, r1), (ta, tb, _) in zip(bands, firsts):
        qa, qb = int8_xla.dyn_requant_plain(ta, amax_ab[0]), int8_xla.dyn_requant_plain(tb, amax_ab[1])
        assert qa.dtype == torch.int8
        out = int8_xla.light53_int8_xla_dyn_codes_plain(xb, qa, qb, *wa2, *wb2, amax_ab, acc, 0.1, 0.9)
        got.append(out[:, r0:r1])
    assert torch.equal(torch.cat(got, 1), want)


def _crafted_sums(targets):
    """int8 codes x (1, 5, 5, 128) and weights (5, 5, 128, len(targets)) whose
    centre output sums to each target exactly."""
    c, k = 128, 5
    x = np.full((1, 5, 5, c), 127, np.int8)
    x[0, 0, 0, 0] = 1
    w = np.zeros((k * k * c, len(targets)), np.int64)
    for j, t in enumerate(targets):
        wb = (t + 63) % 127 - 63  # through the one code 1
        rest = (t - wb) // 127
        base, extra = divmod(abs(rest), k * k * c - 1)
        vals = np.full(k * k * c - 1, base)
        vals[:extra] += 1
        w[1:, j], w[0, j] = vals * np.sign(rest), wb
    return x, w.reshape(k, k, c, len(targets)).astype(np.int8)


def test_bf16_accumulator_rounds_twice_above_2_24(monkeypatch):
    """Sums above 2^24 under ``IEK_INT8_ACC=bf16``: XLA converts the s32 sum to
    float32 and then to bf16, so 2^25 + 2^17 + 1 lands on the bf16 tie 2^25 +
    2^17 and rounds to even (2^25), where one rounding of the exact sum gives
    2^25 + 2^18; the port rounds the same way.  (These sums are exact in
    XLA's float32 conv; where it is not, XLA's bf16 can differ from both.)"""
    targets = [2 ** 25 + 2 ** 17 + 1, 2 ** 24 + 2 ** 16 + 1, 2 ** 24 + 2 ** 16 + 3, -(2 ** 25 + 2 ** 17 + 1),
               2 ** 25 + 3 * 2 ** 17 + 1, 40000001, 1234567]
    x, w = _crafted_sums(targets)
    monkeypatch.setenv("IEK_INT8_ACC", "bf16")
    with jax.disable_jit():
        want = np.asarray(jax_dp._qconv_xla(jnp.asarray(x), jnp.asarray(w)).astype(jnp.float32))[0, 2, 2]
    got = int8_xla._acc(torch.from_numpy(x).float(), torch.from_numpy(w), "bf16")[0, 2, 2].numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 2.0 ** 25 and got[3] == -(2.0 ** 25)
    once = torch.tensor(targets, dtype=torch.float64)
    assert float(once[0]) - 2 ** 25 > 2 ** 17  # above the tie: rounding once would go up
    assert (np.abs(want.astype(np.float64) - np.asarray(targets, np.float64)) > 2 ** 10).sum() >= 5


# -- the forward ----------------------------------------------------------------

def _forward_parts(jq, qp, xj, xt):
    """(name, JAX call, port call) for the parts of the XLA int8 forward."""
    with jax.disable_jit():
        hj = jax_dp.apply_didbl_int8_xla_body(jq, xj, n_body53=2, n_light=1)
    ht = dp.apply_didbl_int8_xla_body(qp, xt, n_body53=2, n_light=1)
    return {
        "body": (lambda: hj, lambda: ht),
        "body_tiled": (lambda: jax_dp.apply_didbl_int8_xla_body_tiled(jq, xj, n_body53=2, n_light=1, tile=4, seg=2),
                       lambda: dp.apply_didbl_int8_xla_body_tiled(qp, xt, n_body53=2, n_light=1, tile=4, seg=2)),
        "tail": (lambda: jax_dp.apply_didbl_int8_xla_tail(jq, hj, n_tail53=1),
                 lambda: dp.apply_didbl_int8_xla_tail(qp, ht, n_tail53=1)),
        "tail_dynamic": (lambda: jax_dp.apply_didbl_int8_xla_tail(jq, hj, n_tail53=1, dynamic=True),
                         lambda: dp.apply_didbl_int8_xla_tail(qp, ht, n_tail53=1, dynamic=True)),
        "forward": (lambda: jax_dp.apply_didbl_int8_xla(jq, xj, **BLOCKS),
                    lambda: dp.apply_didbl_int8_xla(qp, xt, **BLOCKS)),
    }


@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("part", ["body", "body_tiled", "tail", "tail_dynamic", "forward"])
def test_forward_parts_bit_equal_eager_jax(narrow, monkeypatch, part, acc):
    """Body, tiled body (tiles of 4 in segments of 2 blocks, halo 6 and 5:
    really tiled on 20x28), tail, dynamic tail and ``apply_didbl_int8_xla`` on
    a 2 x 20x28 batch (the tiled body on one image: it tiles batch-1 frames)."""
    _, _, jq, qp = narrow
    monkeypatch.setenv("IEK_INT8_ACC", acc)
    n = 1 if part == "body_tiled" else 2
    x = np.random.default_rng(6).random((n, 20, 28, 3)).astype(np.float32)
    jfn, pfn = _forward_parts(jq, qp, jnp.asarray(x), torch.from_numpy(x))[part]
    with jax.disable_jit():
        want = _np(jfn())
    got = pfn()
    assert got.dtype == (torch.float32 if part.startswith(("tail", "forward")) else torch.bfloat16)
    np.testing.assert_array_equal(_np(got), want)


def test_tiled_body_equals_untiled(narrow, caplog):
    _, _, _, qp = narrow
    x = torch.from_numpy(np.random.default_rng(7).random((1, 20, 28, 3)).astype(np.float32))
    want = dp.apply_didbl_int8_xla_body(qp, x, n_body53=2, n_light=1)
    assert torch.equal(dp.apply_didbl_int8_xla_body_tiled(qp, x, n_body53=2, n_light=1, tile=4, seg=2), want)
    # too small to tile (and batched): the untiled chain, with a warning
    assert torch.equal(dp.apply_didbl_int8_xla_body_tiled(qp, x, n_body53=2, n_light=1, tile=16, seg=4), want)


@pytest.mark.parametrize("acc", ["bf16", "s32"])
def test_emit_s8_equals_wide(narrow, monkeypatch, acc):
    """``IEK_INT8_EMIT=s8`` (the fused requantization) is bit-equal to wide, as in JAX."""
    _, _, jq, qp = narrow
    monkeypatch.setenv("IEK_INT8_ACC", acc)
    x = torch.from_numpy(np.random.default_rng(8).random((2, 20, 28, 3)).astype(np.float32))
    monkeypatch.setenv("IEK_INT8_EMIT", "wide")
    wide = dp.apply_didbl_int8_xla(qp, x, **BLOCKS)
    monkeypatch.setenv("IEK_INT8_EMIT", "s8")
    s8 = dp.apply_didbl_int8_xla(qp, x, **BLOCKS)
    assert torch.equal(s8, wide)
    with jax.disable_jit():
        want = jax_dp.apply_didbl_int8_xla(jq, jnp.asarray(x.numpy()), **BLOCKS)
    np.testing.assert_array_equal(s8.numpy(), np.asarray(want))


@pytest.mark.parametrize("knob", ["IEK_INT8_MERGE55", "IEK_INT8_UPQ", "IEK_INT8_UPMM"])
def test_unported_env_knobs_raise(narrow, monkeypatch, knob):
    """The research knobs, once refused here, run: ``apply_didbl_int8_xla``
    under each equals JAX's op by op as uint8 (the knobs in every mode:
    tests/test_torch_int8_knobs.py).  Bytes, since the bf16 ``out`` conv
    sums in float32 in another order than XLA's and may move one bf16 LSB
    of the float output (1 of these 3072 values under UPQ; the blocks
    before it are bit-equal)."""
    _, _, jq, qp = narrow
    monkeypatch.setenv(knob, "1")
    x = np.random.default_rng(9).random((1, 8, 8, 3)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax_dp.apply_didbl_int8_xla(jq, jnp.asarray(x), **BLOCKS))
    got = dp.apply_didbl_int8_xla(qp, torch.from_numpy(x), **BLOCKS).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -8
    np.testing.assert_array_equal(np.round(got * 255.0), np.round(want * 255.0))


def test_uncalibrated_tree_and_other_models_are_refused(narrow):
    module, pn, _, _ = narrow
    with pytest.raises(ValueError, match="needs calibrated activation scales"):
        dp.apply_didbl_int8_xla(dp.quantize_didbl_params(params_from_numpy(pn), **BLOCKS),
                                torch.zeros(1, 8, 8, 3), **BLOCKS)
    assert zoo_int8.int8_support(torch.nn.Identity()) is None
    sup = zoo_int8.int8_support(DifvdsrDouble(**NARROW))
    assert len(sup) == 4 and all(callable(f) for f in sup)


# -- the engine -----------------------------------------------------------------

#: engine modes on a 20x28 image: patch tiles of 24/16, split stripes of 4 rows,
#: split2d tiles of 8 (12 tiles, a chunk of 8 and a remainder)
MODES = {"patch": dict(mode="patch"), "fast": dict(mode="fast"), "split": dict(mode="split", split_tile=4),
         "split2d": dict(mode="split", split_tile=8, split_tile_w=8)}


def _engines(narrow, attrs=None, **kw):
    """The JAX and the port engine on the narrow model, both with JAX's quantized tree."""
    module, pn, jq, qp = narrow
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "narrow", None)
    jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn), module_and_spec=(module, jspec),
                                  patch=24, step=16, forward="int8", **kw)
    pmod = DifvdsrDouble(**NARROW)
    pspec = port_zoo.ModelSpec("didbl", lambda **k: pmod, 4, False, "narrow", None)
    pr = port_engine.SuperResolver(params=pn, module_and_spec=(pmod, pspec), patch=24, step=16, forward="int8",
                                   device="cpu", **kw)
    jr._qparams, pr._qparams = jq, qp
    for k, v in (attrs or {}).items():
        setattr(jr, k, v)
        setattr(pr, k, v)
    return jr, pr


def _u8_gap(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("acc", ["bf16", "s32"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_byte_equal_eager_jax(narrow, monkeypatch, mode, acc):
    """Patch, fast, split and split2d: byte-equal to JAX's engine run op by op.
    Against the jitted JAX engine (what the JAX CLI runs) the distance is
    JAX's own from op by op to jitted: none under s32; under bf16 the jitted
    engine drops the accumulator's rounding (measured: 15.5% of the values,
    by up to 2 levels)."""
    monkeypatch.setenv("IEK_INT8_ACC", acc)
    img = np.random.default_rng(11).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    jr, pr = _engines(narrow, **MODES[mode])
    with jax.disable_jit():
        want = np.asarray(jr.upscale(img))
    got = pr.upscale(img)
    assert got.shape == (80, 112, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    jitted = np.asarray(_engines(narrow, **MODES[mode])[0].upscale(img))
    dmax, frac = _u8_gap(got, jitted)
    print(f"int8 {mode} acc {acc}: port vs the jitted JAX engine: max {dmax} levels on {frac:.3g} of the values")
    assert dmax <= INT8_MAX_DIFF
    if acc == "s32":
        assert frac == 0.0


@pytest.mark.parametrize("case", ["dynamic_tail_fast", "dynamic_tail_split2d", "body_tile_fast", "body_tile_split"])
def test_engine_int8_options_byte_equal_eager_jax(narrow, case):
    """``int8_dynamic_tail`` (per-sample scales: per tile in split2d) and
    ``int8_body_tile`` (the body over shifted tiles of 4 in segments of 2)."""
    attrs = dict(int8_dynamic_tail=True) if case.startswith("dynamic") else dict(int8_body_tile=4, int8_body_seg=2)
    mode = MODES[case.rsplit("_", 1)[1]]
    img = np.random.default_rng(12).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    jr, pr = _engines(narrow, attrs, **mode)
    with jax.disable_jit():
        want = np.asarray(jr.upscale(img))
    got = pr.upscale(img)
    np.testing.assert_array_equal(got, want)
    if case.startswith("body_tile"):
        _, plain = _engines(narrow, **mode)
        np.testing.assert_array_equal(plain.upscale(img), got)


def test_engine_int8_ignores_the_dtype(narrow):
    """The int8 forward casts to bf16 itself: ``dtype`` and ``mixed`` change nothing, as in JAX."""
    img = np.random.default_rng(13).integers(0, 256, (12, 16, 3), dtype=np.uint8)
    want = _engines(narrow, mode="fast")[1].upscale(img)
    for kw in (dict(dtype="bfloat16"), dict(mixed=True), dict(mixed="tail")):
        np.testing.assert_array_equal(_engines(narrow, mode="fast", **kw)[1].upscale(img), want)


# -- the CLIs -------------------------------------------------------------------

@pytest.fixture()
def cli_setup(narrow, tmp_path, monkeypatch):
    """Both registries patched to the narrow model, its weights in an npz, a
    seeded 20x28 BMP in a directory per package, and both packages'
    quantization replaced by JAX's (op by op) on each package's own
    calibration input, so that the CLIs run the same codes."""
    module, pn, _, _ = narrow
    npz = tmp_path / "narrow.npz"
    np.savez(npz, **flatten_params(pn))
    jspec = jax_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    pspec = port_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    monkeypatch.setattr(jax_engine, "get_model", lambda name, dtype=None, **kw: (FlaxDidbl(dtype=dtype, **NARROW), jspec))
    monkeypatch.setattr(port_engine, "get_model", lambda name, dtype=None, **kw: (DifvdsrDouble(**NARROW), pspec))
    jax_quantize = jax_dp.quantize_didbl_params
    calib_seen = []

    def quantize(params, calib_x=None, **kw):
        with jax.disable_jit():
            return jax_quantize(params, calib_x=calib_x, **kw)

    def port_quantize(params, calib_x=None, **kw):
        calib_seen.append(calib_x.numpy())
        jq = quantize(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params),
                      calib_x=jnp.asarray(calib_x.numpy()), **kw)
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, jq))

    monkeypatch.setattr(jax_dp, "quantize_didbl_params", quantize)
    monkeypatch.setattr(dp, "quantize_didbl_params", port_quantize)
    img = np.random.default_rng(14).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    calib = tmp_path / "calib"
    calib.mkdir()
    _bmp_write(str(calib / "c.bmp"), np.random.default_rng(15).integers(0, 256, (72, 88, 3), dtype=np.uint8))
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        _bmp_write(str(dirs[name] / "img.bmp"), img)
    return dirs, str(npz), str(calib), calib_seen


@pytest.mark.parametrize("argv", [
    ["--mode", "fast"], ["--mode", "patch", "--int8-acc", "s32"],
    ["--mode", "split", "--split-tile", "8", "--split-tile-w", "8", "--dtype", "bfloat16", "--int8-emit", "s8"],
])
def test_main_dirpath_int8_byte_equal_eager_jax_cli(cli_setup, monkeypatch, argv):
    """``--forward int8`` through both CLIs (the JAX one op by op), each with
    its own calibration input (``--int8-calib-dir``, one 72x88 image), the
    env knobs set for the run and restored after it."""
    dirs, npz, calib, calib_seen = cli_setup
    monkeypatch.delenv("IEK_INT8_ACC", raising=False)
    monkeypatch.delenv("IEK_INT8_EMIT", raising=False)
    common = ["--weights", npz, "--forward", "int8", "--int8-calib-dir", calib, "--patch_size", "24", "--step", "16",
              *argv]
    with jax.disable_jit():
        assert jax_main([str(dirs["jax"]), *common]) == 0
    assert port_main([str(dirs["port"]), *common, "--device", "cpu"]) == 0
    assert "IEK_INT8_ACC" not in os.environ and "IEK_INT8_EMIT" not in os.environ
    assert len(calib_seen) == 1 and calib_seen[0].shape == (1, 18, 18, 3)
    got = imread(str(dirs["port"] / "img_scaled(1x).bmp"))
    want = imread(str(dirs["jax"] / "img_scaled(1x).bmp"))
    assert got.shape == (80, 112, 3)
    np.testing.assert_array_equal(got, want)


def test_main_dirpath_int8_acc_changes_the_output_and_env_is_restored(cli_setup, monkeypatch):
    dirs, npz, calib, _ = cli_setup
    monkeypatch.setenv("IEK_INT8_ACC", "f32")
    outs = {}
    for acc in ("bf16", "s32"):
        d = dirs["port"] / acc
        d.mkdir()
        _bmp_write(str(d / "img.bmp"), imread(str(dirs["port"] / "img.bmp")))
        assert port_main([str(d), "--weights", npz, "--forward", "int8", "--mode", "fast", "--int8-acc", acc,
                          "--int8-calib-dir", calib, "--device", "cpu"]) == 0
        outs[acc] = imread(str(d / "img_scaled(1x).bmp"))
        assert os.environ["IEK_INT8_ACC"] == "f32"
    assert not np.array_equal(outs["bf16"], outs["s32"])


def test_scorpath_generate_int8_matches_eager_jax_cli(cli_setup, tmp_path, monkeypatch):
    """``scorpath --generate --forward int8`` (patch mode, tiles of 24/16, the
    bundled-photo calibration) on one 40x52 image: the same reconstruction,
    so the same scores up to the scorers' own float32 sums."""
    from PIL import Image

    _, npz, _, _ = cli_setup
    for cls in (jax_engine.SuperResolver, port_engine.SuperResolver):  # small tiles for a small image
        orig = cls.__init__
        monkeypatch.setattr(cls, "__init__", lambda self, *a, _o=orig, **kw: _o(self, *a, patch=24, step=16, **kw))
    d = tmp_path / "gt"
    d.mkdir()
    Image.fromarray(np.random.default_rng(16).integers(0, 256, (40, 52, 3), dtype=np.uint8)).save(d / "img.png")
    jj, pj = tmp_path / "jax.json", tmp_path / "port.json"
    common = [str(d), "--generate", "--weights", npz, "--forward", "int8", "--crop", "4"]
    with jax.disable_jit():
        assert jax_scorpath([*common, "--json", str(jj)]) == 0
    assert port_scorpath([*common, "--json", str(pj), "--device", "cpu"]) == 0
    want, got = json.loads(jj.read_text()), json.loads(pj.read_text())
    assert abs(got["psnr_y"] - want["psnr_y"]) <= 1e-4  # tests/test_torch_eval.py's DB_ATOL, UNIT_ATOL
    assert abs(got["ssim_y"] - want["ssim_y"]) <= 1e-5
