"""The port's bf16 serving profile against the JAX package on the CPU.

The same numpy-seeded inputs (bf16 activations, float32 weights, scaled as
flax's lecun-normal init) go through JAX (the Pallas kernels in interpret
mode, the flax module, ``apply_didbl_pallas`` and the engine) and through
the port (the kernels' plain bf16 versions, which the wrappers take on CPU
tensors).  Both sides sum in float32 in different orders, and a sum that
lands near a bf16 rounding midpoint rounds the other way; a flipped
intermediate then moves its neighbours' sums.  So the bounds are:

* one block (K1, K2) and a chain of K = 1 (K6, K7): at most 1e-3 of the
  elements differ, each by at most as many bf16 ulps of its magnitude as
  the output has roundings that a flipped intermediate can move: one for a
  block (its float32 combine rounds once), two for a chain (bf16(res*y)
  and the final sum).  An output near zero is a sum that cancelled, and an
  intermediate that rounded the other way moves it by an ulp of its terms,
  not of itself, so the magnitude counts as at least 2^-6 max|ref| for a
  block (JAX's Pallas block and the same block written with ``lax.conv``
  differ by up to 68 ulps of values near zero, by one ulp at 2^-7 max|ref|;
  the card's kernels by 17/16 ulp there) and res * max|ref| for a chain,
  whose branch sums round at their own magnitude and enter the output
  scaled by res = 0.1;
* a chain of K = 3, where flips cascade through bf16 combines:
  max |d| <= 2^-6 max|ref| and mean |d| <= 1e-4 max|ref|;
* whole forwards (features 128, 2 + 1 + 1 blocks, 12x12 input), each bf16
  path against its own JAX path: the uint8 outputs within 1 level on under
  3% of the values, the mean |d| of the float outputs <= 0.025 levels.  The
  phase upsample in place of the ``pallas`` paths' dense x4 moves several
  percent of the uint8 values, and the tests show it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.models.didbl_pallas import apply_didbl_pallas as jax_apply_pallas
from image_enhance_keras_tpu.ops.pallas.blocks import fused_light53_block as pallas_light53_block
from image_enhance_keras_tpu.ops.pallas.blocks import fused_light_block as pallas_light_block
from image_enhance_keras_tpu.ops.pallas.tower import fused_light53_chain as pallas_light53_chain
from image_enhance_keras_tpu.ops.pallas.tower import fused_light_chain as pallas_light_chain
from image_enhance_keras_tpu_torch.models import didbl_pallas
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.blocks import profile_dtype
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.didbl_pallas import apply_didbl_pallas
from image_enhance_keras_tpu_torch.models.weights import load_params, params_from_numpy
from image_enhance_keras_tpu_torch.ops import resize
from image_enhance_keras_tpu_torch.ops.cuda import bf16
from image_enhance_keras_tpu_torch.ops.cuda import blocks as kb
from image_enhance_keras_tpu_torch.ops.cuda import tower as kt

C = 128
#: one block, or a chain of one: share of elements that may differ, each by
#: BLOCK_ULPS / CHAIN_ULPS ulps of its magnitude, counted as at least
#: NEAR_ZERO * max|ref| for a block, CHAIN_NEAR_ZERO * max|ref| for a chain
BLOCK_FRAC, NEAR_ZERO, CHAIN_NEAR_ZERO = 1e-3, 2.0 ** -6, 0.1
BLOCK_ULPS, CHAIN_ULPS = 1.0, 2.0
#: a chain of three: max and mean |d| as fractions of max|ref|
CHAIN_MAX, CHAIN_MEAN = 2.0 ** -6, 1e-4
#: whole forwards: uint8 values within 1 level on under U8_FRAC, mean |d| in levels
U8_FRAC, MEAN_LEVELS = 0.03, 0.025
BLOCKS = dict(n_body53=2, n_light=1, n_tail53=1)
SIZES = {"light53": (3, 5, 5, 3), "light": (3, 3)}


def _inputs(which, shape, seed, lead=()):
    """bf16-valued x and float32 (kernel, bias) pairs, kernels lecun-scaled."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    args = []
    for ks in SIZES[which]:
        args.append((rng.normal(size=(*lead, ks, ks, C, C)) / np.sqrt(ks * ks * C)).astype(np.float32))
        args.append((rng.normal(size=(*lead, C)) * 0.05).astype(np.float32))
    return x, args


def _jax_bf16(fn, x, args):
    return np.asarray(fn(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, args), interpret=True)
                      .astype(jnp.float32))


def _port_bf16(fn, x, args):
    return fn(torch.from_numpy(x).to(torch.bfloat16), *map(torch.from_numpy, args)).float().numpy()


def _assert_ulps(got, want, what, near_zero=NEAR_ZERO, max_ulps=BLOCK_ULPS):
    frac, ulps = bf16.ulp_gaps(torch.from_numpy(got), torch.from_numpy(want), near_zero)
    print(f"{what}: {frac:.3g} of elements differ, largest gap {ulps:.3g} bf16 ulp")
    assert frac <= BLOCK_FRAC and ulps <= max_ulps, (frac, ulps)


@pytest.mark.parametrize("shape", [(2, 12, 12, C), (1, 9, 13, C)], ids=["2x12x12", "ragged-9x13"])
@pytest.mark.parametrize("which", sorted(SIZES))
def test_bf16_block_matches_pallas(which, shape):
    """K1 / K2 in bf16: the port's plain bf16 block against the Pallas block
    on bf16 x (interpret mode), which casts the weights to bf16 and combines
    in float32."""
    pallas, port = {"light53": (pallas_light53_block, kb.fused_light53_block),
                    "light": (pallas_light_block, kb.fused_light_block)}[which]
    x, args = _inputs(which, shape, seed=len(which) + shape[1])
    _assert_ulps(_port_bf16(port, x, args), _jax_bf16(pallas, x, args), f"{which} block {shape}")


@pytest.mark.parametrize("k_blocks", [1, 3])
@pytest.mark.parametrize("which", sorted(SIZES))
def test_bf16_chain_matches_pallas(which, k_blocks):
    """K6 / K7 in bf16: each conv plus bias rounds to bf16 and the combine
    runs in bf16 with bf16 scales, as ``_light53_body`` / ``_light_body``."""
    pallas, port = {"light53": (pallas_light53_chain, kt.fused_light53_chain),
                    "light": (pallas_light_chain, kt.fused_light_chain)}[which]
    x, args = _inputs(which, (2, 12, 12, C), seed=10 + k_blocks, lead=(k_blocks,))
    got, want = _port_bf16(port, x, args), _jax_bf16(pallas, x, args)
    if k_blocks == 1:
        _assert_ulps(got, want, f"{which} chain K=1", CHAIN_NEAR_ZERO, CHAIN_ULPS)
        return
    d, ref = np.abs(got - want), float(np.abs(want).max())
    print(f"{which} chain K=3: max |d| {d.max():.3g}, mean |d| {d.mean():.3g}, max|ref| {ref:.3g}, "
          f"{(d > 0).mean():.3g} of elements differ")
    assert d.max() <= CHAIN_MAX * ref and d.mean() <= CHAIN_MEAN * ref


def test_bf16_plain_versions_round_where_the_kernels_do():
    """The bf16 block combines in float32 and rounds once at the end; the
    chain rounds after each conv and each combine step: on the same input
    one Light block differs between the two, and a float64 sum of the same
    products moves each by a few flips only."""
    x, args = _inputs("light", (1, 8, 8, C), seed=3)
    xt, at = torch.from_numpy(x).to(torch.bfloat16), [torch.from_numpy(a) for a in args]
    block = kb.light_block_plain(xt, *at)
    chain = kt.light_chain_plain(xt, *(a[None] for a in at))
    assert block.dtype == chain.dtype == torch.bfloat16
    assert not torch.equal(block, chain)
    exact = kb.light_block_bf16(xt, *at, sum_dtype=torch.float64)
    assert (block != exact).float().mean().item() < 1e-2
    assert bf16.scalar(0.9) == 0.8984375 and bf16.scalar(0.1) == 0.10009765625


@pytest.fixture(scope="module")
def wide():
    """The didbl at features 128 with 2 + 1 + 1 blocks, flax-initialised, and a 2x12x12 input."""
    x = np.random.default_rng(0).random((2, 12, 12, 3)).astype(np.float32)
    module = FlaxDidbl(features=128, dtype=jnp.bfloat16, **BLOCKS)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return x, module, params, jax.tree_util.tree_map(np.asarray, params)


def _assert_u8_close(got, want, what):
    """Float outputs in [0, 1]: uint8 values within 1 level on under U8_FRAC."""
    g8, w8 = (np.clip(np.round(a * 255.0), 0, 255) for a in (got, want))
    assert w8.std() > 10.0  # not an image of zeros
    d = np.abs(g8 - w8)
    mean = float(np.abs(got - want).mean() * 255.0)
    print(f"{what}: uint8 max diff {d.max():.0f}, {(d > 0).mean():.3g} of values differ, "
          f"mean |d| {mean:.3g} levels")
    assert d.max() <= 1 and (d > 0).mean() < U8_FRAC and mean <= MEAN_LEVELS


def test_bf16_module_matches_flax(wide):
    x, module, params, pn = wide
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    mod = DifvdsrDouble(features=128, dtype="bfloat16", **BLOCKS)
    load_params(mod, pn)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert got.dtype == torch.float32 and all(p.dtype == torch.float32 for p in mod.parameters())
    assert mod.body53_0.conv_a1(torch.zeros(1, 4, 4, C)).dtype == torch.bfloat16
    _assert_u8_close(got.numpy(), want, "module bf16")


@pytest.mark.parametrize("chain", [False, True], ids=["pallas", "pallas_chain"])
def test_bf16_kernel_forward_matches_jax(wide, chain):
    x, _, params, pn = wide
    want = np.asarray(jax_apply_pallas(params, jnp.asarray(x), dtype=jnp.bfloat16, interpret=True,
                                       chain=chain, **BLOCKS))
    got = apply_didbl_pallas(params_from_numpy(pn), torch.from_numpy(x), dtype=torch.bfloat16, chain=chain,
                             **BLOCKS)
    assert got.dtype == torch.float32 and got.shape == (2, 48, 48, 3)
    _assert_u8_close(got.numpy(), want, f"apply_didbl_pallas bf16 chain={chain}")


def test_bf16_pallas_forward_keeps_the_dense_x4(wide, monkeypatch):
    """The ``pallas`` paths' x4 is two dense contractions in bf16 (JAX
    ``resize_bilinear_tf1``), not the module's phase upsample: in bf16 the
    two round differently, and the phase upsample misses the bounds."""
    x, _, params, pn = wide
    want = np.asarray(jax_apply_pallas(params, jnp.asarray(x), dtype=jnp.bfloat16, interpret=True, **BLOCKS))
    pt = params_from_numpy(pn)
    monkeypatch.setattr(didbl_pallas, "resize_bilinear_tf1",
                        lambda h, hw: resize.upsample_phase_plain(h, hw[0] // h.shape[-3]))
    wrong = apply_didbl_pallas(pt, torch.from_numpy(x), dtype=torch.bfloat16, **BLOCKS).numpy()
    with pytest.raises(AssertionError):
        _assert_u8_close(wrong, want, "apply_didbl_pallas bf16 with the phase upsample")


def _resolvers(wide, **kw):
    """The JAX and the port's SuperResolver over the wide model, tiles of 24 at step 16."""
    _, module, _, pn = wide
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "wide", None)
    jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn), dtype=jnp.bfloat16,
                                  module_and_spec=(module, jspec), patch=24, step=16, **kw)
    pmod = DifvdsrDouble(features=128, dtype=torch.bfloat16, **BLOCKS)
    pspec = port_zoo.ModelSpec("didbl", lambda **k: pmod, 4, False, "wide", None)
    pr = port_engine.SuperResolver(params=pn, dtype=torch.bfloat16, module_and_spec=(pmod, pspec),
                                   device="cpu", patch=24, step=16, **kw)
    return jr, pr


@pytest.mark.parametrize("forward", ["xla", "pallas", "pallas_chain"])
@pytest.mark.parametrize("mode", ["patch", "fast"])
def test_bf16_engine_matches_jax(wide, mode, forward):
    jr, pr = _resolvers(wide, mode=mode, forward=forward)
    img = np.random.default_rng(11).integers(0, 256, (16, 20, 3), dtype=np.uint8)
    got = pr.upscale(img)
    want = np.asarray(jr.upscale(img))
    assert got.shape == want.shape == (64, 80, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"engine bf16 {mode} {forward}: uint8 max diff {d.max()}, {(d > 0).mean():.3g} of values differ")
    assert d.max() <= 1 and (d > 0).mean() < U8_FRAC


def test_profiles():
    assert profile_dtype(None) == profile_dtype("float32") == profile_dtype(torch.float32) == torch.float32
    assert profile_dtype("bfloat16") == profile_dtype(torch.bfloat16) == torch.bfloat16
    for dtype in (torch.float16, "mixed", "mixed-tail", []):
        with pytest.raises(NotImplementedError, match="is not a profile"):
            profile_dtype(dtype)
    # internal learning is ported: an unported profile under it still raises
    with pytest.raises(NotImplementedError, match="is not a profile"):
        port_engine.SuperResolver(dtype=torch.float16, forward="int8", device="cpu", weights=None, internal_learn=1)


# -- the CLIs, at a narrow width (features 16) -----------------------------------

NARROW = dict(features=16, **BLOCKS)


@pytest.fixture()
def narrow_cli(tmp_path, monkeypatch):
    """Both registries patched to the narrow model in the asked dtype; its
    float32 weights (flax's init from key 3, as tests/test_torch_engine.py,
    whose outputs are not all near zero) in an npz; a seeded 20x28 image in a
    directory per package."""
    from image_enhance_keras_tpu_torch.data.io import _bmp_write
    from image_enhance_keras_tpu_torch.models.weights import flatten_params

    params = FlaxDidbl(**NARROW).init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))["params"]
    npz = tmp_path / "narrow.npz"
    np.savez(npz, **flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    jspec = jax_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    pspec = port_zoo.ModelSpec("didbl", None, 4, False, "narrow", None)
    monkeypatch.setattr(jax_engine, "get_model",
                        lambda name, dtype=None, **kw: (FlaxDidbl(dtype=dtype, **NARROW), jspec))
    monkeypatch.setattr(port_engine, "get_model",
                        lambda name, dtype=None, **kw: (DifvdsrDouble(dtype=dtype, **NARROW), pspec))
    img = np.random.default_rng(5).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        _bmp_write(str(dirs[name] / "img.bmp"), img)
    return dirs, str(npz)


@pytest.mark.parametrize("forward", ["pallas", "pallas_chain"])
def test_bf16_cli_matches_jax_cli(narrow_cli, forward):
    from image_enhance_keras_tpu.cli.main_dirpath import main as jax_main
    from image_enhance_keras_tpu_torch.cli.main_dirpath import main as port_main
    from image_enhance_keras_tpu_torch.data.io import imread

    dirs, npz = narrow_cli
    common = ["--weights", npz, "--forward", forward, "--dtype", "bfloat16", "--patch_size", "24", "--step", "16"]
    assert jax_main([str(dirs["jax"]), *common]) == 0
    assert port_main([str(dirs["port"]), *common, "--device", "cpu"]) == 0
    got = imread(str(dirs["port"] / "img_scaled(1x).bmp"))
    want = imread(str(dirs["jax"] / "img_scaled(1x).bmp"))
    assert got.shape == want.shape == (80, 112, 3) and want.std() > 10.0
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"main_dirpath --dtype bfloat16 --forward {forward}: uint8 max diff {d.max()}, "
          f"{(d > 0).mean():.3g} of values differ")
    assert d.max() <= 1 and (d > 0).mean() < U8_FRAC


def test_bf16_scorpath_generate_matches_jax_cli(narrow_cli, tmp_path, monkeypatch):
    """--generate --dtype bfloat16 on one 40x52 image; 1 level on under 3%
    of the values moves PSNR-Y by under 0.05 dB and SSIM-Y by under 1e-3."""
    from PIL import Image

    from image_enhance_keras_tpu.cli.scorpath import main as jax_scorpath
    from image_enhance_keras_tpu_torch.cli.scorpath import main as port_scorpath

    _, npz = narrow_cli
    for cls in (jax_engine.SuperResolver, port_engine.SuperResolver):  # small tiles for a small image
        orig = cls.__init__
        monkeypatch.setattr(cls, "__init__", lambda self, *a, _o=orig, **kw: _o(self, *a, patch=24, step=16, **kw))
    d = tmp_path / "gt"
    d.mkdir()
    Image.fromarray(np.random.default_rng(8).integers(0, 256, (40, 52, 3), dtype=np.uint8)).save(d / "img.png")
    jj, pj = tmp_path / "jax.json", tmp_path / "port.json"
    common = [str(d), "--generate", "--weights", npz, "--forward", "xla", "--dtype", "bfloat16", "--crop", "4"]
    assert jax_scorpath([*common, "--json", str(jj)]) == 0
    assert port_scorpath([*common, "--json", str(pj), "--device", "cpu"]) == 0
    import json

    want, got = json.loads(jj.read_text()), json.loads(pj.read_text())
    print(f"scorpath --generate --dtype bfloat16: port {got['psnr_y']:.4f} / {got['ssim_y']:.5f}, "
          f"JAX {want['psnr_y']:.4f} / {want['ssim_y']:.5f}")
    assert abs(got["psnr_y"] - want["psnr_y"]) <= 0.05
    assert abs(got["ssim_y"] - want["ssim_y"]) <= 1e-3
