"""Port's Light53 / Light chains against the JAX Pallas chain kernels.

The CUDA kernels (``csrc/tower.cu``) run only on the card: ``chip_smoke.py``
and tests/test_torch_cuda.py hold them against these plain versions there.  Here the wrappers take their plain versions
because the tensors lie on the CPU.  Tolerance 5e-5 as in
tests/test_pallas_tower.py: K float32 blocks summed in another order.

The kernels multiply in split precision (3xTF32): ``split_tf32`` is tested
here, and a plain emulation of the scheme (TF32 hi and lo operands, the
lo*lo term dropped) is held to the same 5e-5 against the JAX chains, and in
the block kernels' (K1/K2, ``csrc/blocks.cu``) combine order to 2e-5
against JAX's single-block kernels.
"""

import jax
import jax.numpy as jnp
import torch.nn.functional as F
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.models.didbl_pallas import apply_didbl_pallas as jax_apply_pallas
from image_enhance_keras_tpu.ops.pallas.blocks import fused_light53_block as pallas_light53_block
from image_enhance_keras_tpu.ops.pallas.blocks import fused_light_block as pallas_light_block
from image_enhance_keras_tpu.ops.pallas.tower import fused_light53_chain as pallas_light53_chain
from image_enhance_keras_tpu.ops.pallas.tower import fused_light_chain as pallas_light_chain
from image_enhance_keras_tpu_torch.models.didbl_pallas import apply_didbl_pallas
from image_enhance_keras_tpu_torch.models.weights import params_from_numpy
from image_enhance_keras_tpu_torch.ops.cuda import blocks as kb
from image_enhance_keras_tpu_torch.ops.cuda import tower

C = 128
ATOL = 5e-5
#: one float32 block (K1/K2), as in tests/test_pallas_blocks.py
BLOCK_ATOL = 2e-5
#: which chain: (JAX kernel, port wrapper, port plain, block plain, kernel sizes, K, x shape, seed)
CHAINS = {
    "light53": (pallas_light53_chain, tower.fused_light53_chain, tower.light53_chain_plain,
                kb.light53_block_plain, (3, 5, 5, 3), 3, (2, 8, 8, C), 0),
    "light": (pallas_light_chain, tower.fused_light_chain, tower.light_chain_plain,
              kb.light_block_plain, (3, 3), 4, (1, 10, 6, C), 1),
}


def _inputs(which, device="cpu"):
    """numpy-seeded x and stacked (kernel, bias) pairs, He-scaled like flax's init."""
    _, _, _, _, sizes, k, shape, seed = CHAINS[which]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    args = []
    for ks in sizes:
        args.append((rng.normal(size=(k, ks, ks, C, C)) * (2.0 / (ks * ks * C)) ** 0.5).astype(np.float32))
        args.append((rng.normal(size=(k, C)) * 0.05).astype(np.float32))
    return x, args


@pytest.mark.parametrize("which", sorted(CHAINS))
def test_plain_chain_matches_pallas_chain(which):
    pallas, _, plain, *_ = CHAINS[which]
    x, args = _inputs(which)
    want = np.asarray(pallas(jnp.asarray(x), *(jnp.asarray(a) for a in args), interpret=True))
    got = plain(torch.from_numpy(x), *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("which", sorted(CHAINS))
def test_plain_chain_matches_sequential_blocks(which):
    _, _, plain, block, _, k, _, _ = CHAINS[which]
    x, args = _inputs(which)
    xt, at = torch.from_numpy(x), [torch.from_numpy(a) for a in args]
    want = xt
    for i in range(k):
        want = block(want, *(a[i] for a in at))
    np.testing.assert_allclose(plain(xt, *at).numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("which", sorted(CHAINS))
def test_cpu_wrapper_takes_plain_version(which):
    _, wrapper, plain, *_ = CHAINS[which]
    x, args = _inputs(which)
    xt, at = torch.from_numpy(x), [torch.from_numpy(a) for a in args]
    before = wrapper.launches
    assert torch.equal(wrapper(xt, *at), plain(xt, *at))
    assert wrapper.launches == before  # the count is of kernel launches only


def test_wrappers_reject_bad_args():
    x, args = _inputs("light")
    xt, at = torch.from_numpy(x), [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="stacked"):
        tower.fused_light_chain(xt, at[0][0], *at[1:])
    with pytest.raises(ValueError, match="bias shape"):
        tower.fused_light_chain(xt, at[0], at[1][:2], *at[2:])
    with pytest.raises(ValueError, match="kernel shape"):
        tower.fused_light_chain(xt, at[0], at[1], at[2][:2], at[3])
    with pytest.raises(TypeError, match="float32"):
        tower.fused_light_chain(xt.double(), *at)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tower.fused_light_chain(xt.to("meta"), *(a.to("meta") for a in at))


def test_didbl_chain_forward_matches_jax_chain_and_block_forward():
    """The narrow didbl through chain=True against JAX's chain=True (interpret)
    and the port's per-block kernel forward, at the whole forward's 3e-5."""
    blocks = dict(n_body53=2, n_light=1, n_tail53=1)
    x = np.random.default_rng(5).random((2, 12, 12, 3)).astype(np.float32)
    module = FlaxDidbl(features=16, **blocks)
    params = module.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    want = np.asarray(jax_apply_pallas(params, jnp.asarray(x), interpret=True, chain=True, **blocks))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    got = apply_didbl_pallas(pt, torch.from_numpy(x), chain=True, **blocks).numpy()
    assert got.shape == (2, 48, 48, 3)
    np.testing.assert_allclose(got, want, atol=3e-5)
    per_block = apply_didbl_pallas(pt, torch.from_numpy(x), **blocks).numpy()
    np.testing.assert_allclose(got, per_block, atol=3e-5)


def _split_values(kind, rng):
    if kind == "random":
        return rng.normal(size=4096).astype(np.float32) * 10.0
    if kind == "subnormal":
        return (rng.uniform(-1.0, 1.0, 4096) * np.finfo(np.float32).tiny).astype(np.float32)
    if kind == "zero":
        return np.array([0.0, -0.0] * 8, dtype=np.float32)
    return (np.sign(rng.normal(size=4096)) * 10.0 ** rng.uniform(30, 38, 4096)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "subnormal", "zero", "large"])
def test_split_tf32_is_exact_with_ten_bit_hi(kind):
    v = torch.from_numpy(_split_values(kind, np.random.default_rng(3)))
    hi, lo = tower.split_tf32(v)
    assert torch.equal(hi + lo, v)  # bit for bit (signed zeros compare equal)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0  # at most 10 explicit mantissa bits
    # hi is the nearest TF32 value: lo is at most half of v's TF32 spacing
    # (13 bits above float32's, 2^-136 among the subnormals)
    exponent = torch.frexp(v.double())[1]
    spacing = torch.clamp(torch.ldexp(torch.ones_like(v, dtype=torch.float64), exponent - 11), min=2.0 ** -136)
    assert bool((lo.double().abs() <= spacing / 2).all())


def _conv_3xtf32(x, w, b=None):
    """SAME conv as the float32 kernels multiply: round_tf32 hi and lo of both
    operands, lo*Whi + hi*Wlo + hi*Whi summed exactly, lo*Wlo dropped; the sum
    rounded once to float32, then the bias (if any) added."""
    xh, xl = tower.split_tf32(x)
    wh, wl = tower.split_tf32(w)
    xh, xl, wh, wl = (t.double() for t in (xh, tower.round_tf32(xl), wh, tower.round_tf32(wl)))

    def conv(a, k):
        return F.conv2d(a.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=k.shape[0] // 2).permute(0, 2, 3, 1)

    y = (conv(xl, wh) + conv(xh, wl) + conv(xh, wh)).to(torch.float32)
    return y if b is None else y + b


def _light53_chain_3xtf32(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2):
    for k in range(wa1.shape[0]):
        ya = _conv_3xtf32(torch.relu(_conv_3xtf32(x, wa1[k], ba1[k])), wa2[k], ba2[k])
        yb = _conv_3xtf32(torch.relu(_conv_3xtf32(x, wb1[k], bb1[k])), wb2[k], bb2[k])
        x = 0.9 * x + 0.1 * (ya + yb)
    return x


def _light_chain_3xtf32(x, wa1, ba1, wa2, ba2):
    for k in range(wa1.shape[0]):
        x = x + 0.1 * _conv_3xtf32(torch.relu(_conv_3xtf32(x, wa1[k], ba1[k])), wa2[k], ba2[k])
    return x


@pytest.mark.parametrize("which", ["light53", "light"])
def test_3xtf32_emulation_matches_pallas_chain(which):
    """The full chains (16 Light53, 6 Light) at C = 16 with the kernels'
    3xTF32 products, against JAX's chain kernels in interpret mode."""
    pallas, emulated, sizes, k = {
        "light53": (pallas_light53_chain, _light53_chain_3xtf32, (3, 5, 5, 3), 16),
        "light": (pallas_light_chain, _light_chain_3xtf32, (3, 3), 6),
    }[which]
    c = 16
    rng = np.random.default_rng(8)
    x = np.maximum(rng.normal(size=(1, 8, 8, c)), 0.0).astype(np.float32) * 2.0
    args = []
    for ks in sizes:
        args.append((rng.normal(size=(k, ks, ks, c, c)) * (2.0 / (ks * ks * c)) ** 0.5).astype(np.float32))
        args.append((rng.normal(size=(k, c)) * 0.05).astype(np.float32))
    want = np.asarray(pallas(jnp.asarray(x), *(jnp.asarray(a) for a in args), interpret=True))
    got = emulated(torch.from_numpy(x), *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the split is not a no-op: one TF32 product alone is further off
    one = np.asarray(want)
    assert np.abs(got - one).max() < np.abs(tower.round_tf32(torch.from_numpy(x)).numpy() - x).max()


def _light53_block_3xtf32(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2):
    """K1's two launches: the first convs with bias and relu, then
    res * ((id/res)*x + (ba2 + bb2) + conv5(ta) + conv3(tb)), summed in that order."""
    ta = torch.relu(_conv_3xtf32(x, wa1, ba1))
    tb = torch.relu(_conv_3xtf32(x, wb1, bb1))
    acc = (0.9 / 0.1) * x + (ba2 + bb2)
    acc = acc + _conv_3xtf32(ta, wa2)
    acc = acc + _conv_3xtf32(tb, wb2)
    return 0.1 * acc


def _light_block_3xtf32(x, w1, b1, w2, b2):
    """K2's two launches: x + res * (conv3(relu(conv3(x) + b1)) + b2)."""
    return x + 0.1 * _conv_3xtf32(torch.relu(_conv_3xtf32(x, w1, b1)), w2, b2)


@pytest.mark.parametrize("which", ["light53", "light"])
def test_3xtf32_emulation_matches_pallas_block(which):
    """One Light53 and one Light block at C = 16 on an 8x8 image with the
    block kernels' 3xTF32 products and combine order, against JAX's block
    kernels in interpret mode."""
    pallas, emulated, sizes = {
        "light53": (pallas_light53_block, _light53_block_3xtf32, (3, 5, 5, 3)),
        "light": (pallas_light_block, _light_block_3xtf32, (3, 3)),
    }[which]
    c = 16
    rng = np.random.default_rng(9)
    x = np.maximum(rng.normal(size=(2, 8, 8, c)), 0.0).astype(np.float32) * 2.0
    args = []
    for ks in sizes:
        args.append((rng.normal(size=(ks, ks, c, c)) * (2.0 / (ks * ks * c)) ** 0.5).astype(np.float32))
        args.append((rng.normal(size=c) * 0.05).astype(np.float32))
    want = np.asarray(pallas(jnp.asarray(x), *(jnp.asarray(a) for a in args), interpret=True))
    got = emulated(torch.from_numpy(x), *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=BLOCK_ATOL)


@pytest.mark.parametrize("which", ["light53", "light", "light53_block", "light_block"])
def test_cuda_wrapper_rejects_other_channels(which):
    """The chain (K6/K7) and block (K1/K2) kernels take C = 128 only: a CUDA
    tensor with C = 64 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the check applies to CUDA tensors")
    wrapper, sizes, lead = {
        "light53": (tower.fused_light53_chain, (3, 5, 5, 3), (16,)),
        "light": (tower.fused_light_chain, (3, 3), (6,)),
        "light53_block": (kb.fused_light53_block, (3, 5, 5, 3), ()),
        "light_block": (kb.fused_light_block, (3, 3), ()),
    }[which]
    c = 64
    x = torch.zeros(1, 8, 8, c, device="cuda")
    args = []
    for ks in sizes:
        args += [torch.zeros(*lead, ks, ks, c, c, device="cuda"), torch.zeros(*lead, c, device="cuda")]
    with pytest.raises(ValueError, match="C == 128"):
        wrapper(x, *args)


def test_stacked_chain_weights_are_cached_per_tree():
    """The chain forward stacks (and the kernels' wrappers pack) a loaded tree
    once: the same tensors come back until one of the blocks changes."""
    from image_enhance_keras_tpu_torch.models.didbl_pallas import _stacked

    rng = np.random.default_rng(2)

    def conv():
        return {"kernel": torch.from_numpy(rng.normal(size=(3, 3, 4, 4)).astype(np.float32)),
                "bias": torch.from_numpy(rng.normal(size=4).astype(np.float32))}

    blocks = [{"conv_a": conv(), "conv_b": conv()} for _ in range(3)]
    first = _stacked(blocks, ("conv_a", "conv_b"))
    assert all(a is b for a, b in zip(_stacked(blocks, ("conv_a", "conv_b")), first))
    assert torch.equal(first[2][1], blocks[1]["conv_b"]["kernel"])
    blocks[1]["conv_b"]["kernel"].add_(1.0)
    again = _stacked(blocks, ("conv_a", "conv_b"))
    assert again[2] is not first[2] and torch.equal(again[2][1], blocks[1]["conv_b"]["kernel"])
    blocks[2]["conv_a"] = conv()  # a new tensor in the tree
    assert torch.equal(_stacked(blocks, ("conv_a", "conv_b"))[0][2], blocks[2]["conv_a"]["kernel"])
