"""Port's int8 Light53 / Light blocks with dynamic scales and float32 x, against JAX.

``act_scales=None``: every TPU window quantizes its input window, and each
branch's intermediate over the window's extended ring, with its own abs-max
scale, so the result depends on the window partition (``tile``).  The JAX
kernels run in interpret mode at C = 16; the port's wrappers take their
plain versions (CPU tensors), which unfold the same windows.  Bound as in
tests/test_torch_int8_blocks.py: at most 0.1% of the outputs differ, none by
more than 1% of max|ref| (both compute exact s32 convolutions and round the
float steps at the same points; measured: no value differs in any case).
The whole uncalibrated forward is held at the bound of
test_torch_int8_calib.py::test_apply_didbl_int8_on_jax_qparams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.models import didbl_pallas as jax_dp
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.ops.pallas import int8_blocks as jax_i8
from image_enhance_keras_tpu_torch.models import didbl_pallas as dp
from image_enhance_keras_tpu_torch.models.weights import flatten_params, params_from_numpy
from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as i8

C = 16
MAX_FRAC, MAX_REL = 1e-3, 1e-2
#: (H, W), tile: ragged sides, tiles that do and do not divide the 8-padded
#: image, windows wider than tall, one window for the whole image
CASES = [((16, 16), (8, 16)), ((12, 24), (12, 8)), ((13, 21), (8, 8)), ((40, 24), (8, 16)),
         ((16, 16), (64, 128))]
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}
BLOCKS = dict(n_body53=2, n_light=1, n_tail53=1)


def _weights(which, rng, bias_scale=0.01):
    convs = []
    for k in (3, 5, 5, 3) if which == "light53" else (3, 3):
        w = (rng.standard_normal((k, k, C, C)) * 0.05).astype(np.float32)
        b = (rng.standard_normal(C) * bias_scale).astype(np.float32)
        q, s = jax_i8.quantize_weights_per_channel(w)
        convs.append((np.asarray(q), np.asarray(s), b))
    return convs


def _x(shape, dtype, rng):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32).astype(np.dtype(jnp.dtype(dtype)))


def _run_jax(which, x, convs, tile, act=None):
    fn = jax_i8.light53_int8 if which == "light53" else jax_i8.light_int8
    out = fn(jnp.asarray(x), *[jnp.asarray(a) for c in convs for a in c], tile=tile, interpret=True,
             act_scales=None if act is None else jnp.asarray(act))
    return np.asarray(out.astype(jnp.float32)), out.dtype


def _run_port(which, x, convs, tile, tdtype, act=None):
    fn = i8.light53_int8 if which == "light53" else i8.light_int8
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(tdtype)
    args = [torch.from_numpy(np.array(a)) for c in convs for a in c]
    out = fn(xt, *args, tile=tile, act_scales=None if act is None else torch.from_numpy(act))
    assert out.dtype == tdtype and tuple(out.shape) == tuple(x.shape) and out.is_contiguous()
    return out.float().numpy()


def _gap(got, want):
    d = np.abs(got - want)
    return float((d > 0).mean()), float(d.max() / max(np.abs(want).max(), 1e-30))


def _assert_close(got, want):
    frac, rel = _gap(got, want)
    print(f"differing fraction {frac:.3g}, max |diff| / max|ref| {rel:.3g}")
    assert frac <= MAX_FRAC and rel <= MAX_REL, (frac, rel)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hw,tile", CASES)
@pytest.mark.parametrize("which", ["light53", "light"])
def test_dynamic_matches_jax_interpret(which, hw, tile, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    x = _x((2, *hw, C), jdt, rng)
    convs = _weights(which, rng)
    want, want_dtype = _run_jax(which, x, convs, tile)
    assert want_dtype == jdt
    _assert_close(_run_port(which, x, convs, tile, tdt), want)


@pytest.mark.parametrize("hw,tile", [((13, 21), (8, 8)), ((16, 16), (64, 128))])
@pytest.mark.parametrize("which", ["light53", "light"])
def test_static_float32_matches_jax_interpret(which, hw, tile):
    rng = np.random.default_rng(hw[0])
    x = _x((2, *hw, C), jnp.float32, rng)
    convs = _weights(which, rng)
    act = np.array([np.abs(x).max() / 127, 0.02, 0.03], np.float32)[:3 if which == "light53" else 2]
    want, _ = _run_jax(which, x, convs, tile, act)
    _assert_close(_run_port(which, x, convs, tile, torch.float32, act), want)


def test_dynamic_codes_divide_as_jax():
    """Dynamic codes at exact ties of the scale: x / s rounds half to even,
    where x * (1/s) lands off the tie for some of them; the port's scale and
    codes equal JAX's ``_quantize`` on the same window."""
    rng = np.random.default_rng(8)
    amax = np.float32(1.2345678)
    s = np.float32(amax * np.float32(1.0 / 127.0))
    k = rng.integers(-126, 126, 4096).astype(np.float32)
    x = ((k + np.float32(0.5)) * s).astype(np.float32)
    x[0] = amax
    x = x.reshape(1, 8, 8, 64)
    assert (np.round(x / s) != np.round(x * (np.float32(1) / s))).any()  # the input tells them apart
    q, scale = jax.jit(jax_i8._quantize)(jnp.asarray(x[0]))
    xt = torch.from_numpy(x)
    st = i8._scale_dyn(xt)
    assert st.item() == float(scale)
    np.testing.assert_array_equal(i8._quant_dyn(xt, st)[0].numpy().astype(np.int8), np.asarray(q))


#: (kernel, spike column, moves window 0): with tile (8, 8) window 0 DMAs image
#: columns [-halo, 8 + win_pad - halo) and its convs read [-halo, 8 + halo)
SPIKES = [("light53", 11, True), ("light53", 12, True), ("light53", 13, False),
          ("light", 10, True), ("light", 13, True), ("light", 14, False)]


@pytest.mark.parametrize("which,col,moves", SPIKES)
def test_input_absmax_spans_the_dma_window(which, col, moves):
    """A spike in the columns that only window 0's abs-max spans (right of
    what its convs read) changes window 0's output; one column further does
    not; the port agrees with JAX on both."""
    rng = np.random.default_rng(col)
    x = _x((1, 8, 24, C), jnp.float32, rng)
    convs = _weights(which, rng)
    base = _run_port(which, x, convs, (8, 8), torch.float32)
    x[0, 3, col, 5] = 60.0
    want, _ = _run_jax(which, x, convs, (8, 8))
    got = _run_port(which, x, convs, (8, 8), torch.float32)
    _assert_close(got, want)
    assert (not np.array_equal(got[:, :, :8], base[:, :, :8])) == moves
    assert (not np.array_equal(want[:, :, :8], base[:, :, :8])) == moves


@pytest.mark.parametrize("which", ["light53", "light"])
def test_all_zero_window_takes_the_floor_scale(which):
    """Window 0's input is all zeros and every bias is negative, so its input
    and intermediates quantize with the 1e-12 floor scale (all-zero codes)."""
    rng = np.random.default_rng(3)
    x = _x((1, 16, 24, C), jnp.bfloat16, rng)
    x[:, :12, :14] = 0
    convs = [(q, s, -np.abs(b) - 0.01) for q, s, b in _weights(which, rng)]
    want, _ = _run_jax(which, x, convs, (8, 8))
    got = _run_port(which, x, convs, (8, 8), torch.bfloat16)
    assert np.isfinite(got).all()
    _assert_close(got, want)


@pytest.mark.parametrize("which", ["light53", "light"])
def test_tile_sensitivity(which):
    """The port at tile A agrees with JAX at tile A, while JAX's own outputs
    at tiles A and B differ by more than that bound: ``tile`` is honoured."""
    rng = np.random.default_rng(4)
    x = _x((1, 24, 32, C), jnp.float32, rng)
    x[0, :, 16:] *= 8.0  # windows of different scales
    convs = _weights(which, rng)
    tile_a, tile_b = (8, 8), (24, 32)
    want_a, _ = _run_jax(which, x, convs, tile_a)
    want_b, _ = _run_jax(which, x, convs, tile_b)
    frac, rel = _gap(want_a, want_b)
    assert frac > MAX_FRAC, (frac, rel)
    _assert_close(_run_port(which, x, convs, tile_a, torch.float32), want_a)
    _assert_close(_run_port(which, x, convs, tile_b, torch.float32), want_b)


def test_tiling_invariance():
    """The port's form of tests/test_int8_blocks.py::test_tiling_invariance:
    per-window scales move the result by the int8 LSB, not more."""
    rng = np.random.default_rng(2)
    c = 128
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, c)).astype(np.float32) * 0.5)
    args = []
    for k in (3, 5, 5, 3):
        q, s = i8.quantize_weights_per_channel(
            torch.from_numpy(rng.standard_normal((k, k, c, c)).astype(np.float32) * 0.05))
        args += [q, s, torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.01)]
    a = i8.light53_int8(x, *args, tile=(16, 16)).numpy()
    b = i8.light53_int8(x, *args, tile=(8, 8)).numpy()
    assert not np.array_equal(a, b)
    assert np.abs(a - b).mean() < 0.01 * (np.abs(a).mean() + 1e-6)


@pytest.fixture(scope="module")
def uncalibrated():
    """Narrow didbl params (numpy) and JAX's uncalibrated quantized tree."""
    module = FlaxDidbl(features=16, **BLOCKS)
    params = module.init(jax.random.PRNGKey(6), jnp.zeros((1, 16, 16, 3)))["params"]
    pn = jax.tree_util.tree_map(np.asarray, params)
    jq = jax_dp.quantize_didbl_params(jax.tree_util.tree_map(jnp.asarray, pn), **BLOCKS)
    return pn, jq


def test_uncalibrated_tree_has_no_activation_scales(uncalibrated):
    pn, jq = uncalibrated
    got = dp.quantize_didbl_params(params_from_numpy(pn), **BLOCKS)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jq))
    flat = flatten_params(got)
    assert sorted(flat) == sorted(want)
    assert not any("act" in k.split("/") or "actc" in k.split("/") for k in flat)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)


def test_apply_didbl_int8_uncalibrated_on_jax_qparams(uncalibrated):
    """The uncalibrated forward (every block dynamic) on JAX's tree, tile (8, 8)
    so that the HR tail runs many windows."""
    _, jq = uncalibrated
    x = np.random.default_rng(10).random((2, 12, 14, 3)).astype(np.float32)
    want = np.asarray(jax_dp.apply_didbl_int8(jq, jnp.asarray(x), tile=(8, 8), interpret=True, **BLOCKS))
    qp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq))
    got = dp.apply_didbl_int8(qp, torch.from_numpy(x), tile=(8, 8), **BLOCKS)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 48, 56, 3)
    d = np.abs(got.numpy() - want)
    print(f"uncalibrated apply_didbl_int8: mean |diff| {d.mean():.3g}, max {d.max():.3g}")
    assert d.mean() <= 5e-4 and d.max() <= 1e-2


def test_cpu_wrappers_take_plain_dynamic_versions_and_count_no_launch():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_x((1, 9, 13, C), jnp.float32, rng))
    args = [torch.from_numpy(np.array(a)) for c in _weights("light53", rng) for a in c]
    light = args[:3] + args[9:]
    before = (i8.light53_int8.launches, i8.light_int8.launches)
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        assert torch.equal(i8.light53_int8(xd, *args, tile=(8, 8)),
                           i8.light53_int8_dynamic_plain(xd, *args, (8, 8)))
        assert torch.equal(i8.light_int8(xd, *light, tile=(8, 8)),
                           i8.light_int8_dynamic_plain(xd, *light, (8, 8)))
    assert (i8.light53_int8.launches, i8.light_int8.launches) == before


def _requant_np(ring: np.ndarray) -> np.ndarray:
    """The requantization launch on one window's float32 ring, in numpy:
    s = max(abs-max, 1e-12) * float32(1/127), q = clip(rint(v / s), +-127)."""
    s = np.maximum(np.abs(ring).max(), np.float32(1e-12)) * np.float32(1.0 / 127.0)
    assert s.dtype == np.float32
    return np.clip(np.rint(ring / s), -127, 127).astype(np.int8)


@pytest.mark.parametrize("hw,tile", [((13, 21), (8, 8)), ((16, 40), (16, 24)), ((16, 16), (64, 128))])
@pytest.mark.parametrize("which", ["light53", "light"])
def test_requantized_rings_are_the_plain_codes(which, hw, tile):
    """Each window's float32 ring (what the ring launch stores), requantized
    on its own (what the requantization launch computes), gives the codes the
    plain dynamic version convolves, window by window; the block rebuilt from
    those codes is the plain version's output bit for bit."""
    rng = np.random.default_rng(hw[1] + tile[0])
    xf = torch.from_numpy(_x((2, *hw, C), jnp.float32, rng))
    convs = [tuple(torch.from_numpy(np.array(a)) for a in cv) for cv in _weights(which, rng)]
    halo, rings = (3, (2, 1)) if which == "light53" else (2, (1,))
    win = i8._Windows(xf, halo, tile)
    sx = i8._scale_dyn(win.batch)
    xq = i8._quant_dyn(win.batch, sx)
    parts = []
    for (w1, s1, b1), (w2, s2, b2), d in zip(convs[0::2], convs[1::2], rings):
        t = win.ring(xq, sx, w1, s1, b1, d)
        assert tuple(t.shape[1:3]) == (win.th + 2 * d, win.tw + 2 * d)
        want = i8._quant_dyn(t, i8._scale_dyn(t)).to(torch.int8).numpy()
        codes = np.stack([_requant_np(t[i].numpy()) for i in range(t.shape[0])])
        np.testing.assert_array_equal(codes, want)
        st = i8._scale_dyn(t)
        parts.append(win.stitch(i8._dequant(
            i8._conv_valid_s32(torch.from_numpy(codes).to(torch.float32), w2, win.th, win.tw), st, s2, b2)))
    if which == "light53":
        # the plain version's argument order: branch a (3, 5) then branch b (5, 3)
        got = i8._light53_out(xf, parts[0], parts[1], 0.1, 0.9)
        ref = i8.light53_int8_dynamic_plain(xf, *convs[0], *convs[1], *convs[2], *convs[3], tile)
    else:
        got = i8._light_out(xf, parts[0], 0.1)
        ref = i8.light_int8_dynamic_plain(xf, *convs[0], *convs[1], tile)
    assert torch.equal(got, ref)
