"""The port's CUDA kernels on the card (marked ``cuda``; each skips without one).

Imports no JAX, so it runs on a machine that has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the other tests.)
"""

import numpy as np
import pytest
import torch

from image_enhance_keras_tpu_torch.ops.cuda import blocks, int8_blocks, tower

C = 128
#: K float32 blocks summed in another order (tests/test_pallas_tower.py)
ATOL = 5e-5
#: one float32 block: sums over 68*128 terms in another order (tests/test_pallas_blocks.py)
BLOCK_ATOL = 2e-5
#: which block: wrapper, plain version, kernel sizes
BLOCKS = {
    "light53": (blocks.fused_light53_block, blocks.light53_block_plain, (3, 5, 5, 3)),
    "light": (blocks.fused_light_block, blocks.light_block_plain, (3, 3)),
}
#: which chain: wrapper, plain version, kernel sizes, K (the didbl tower's 16 / 6)
CHAINS = {
    "light53": (tower.fused_light53_chain, tower.light53_chain_plain, (3, 5, 5, 3), 16),
    "light": (tower.fused_light_chain, tower.light_chain_plain, (3, 3), 6),
}
#: (N, H, W): two full 96x96 tiles of the patch pipeline, small images, and
#: ragged crops whose widths fall above and below one 16-column conv tile
CHAIN_SHAPES = [(2, 96, 96), (2, 8, 8), (1, 10, 6), (1, 57, 86), (1, 86, 57), (1, 57, 57), (1, 5, 70), (1, 8, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHAIN_SHAPES)
@pytest.mark.parametrize("which", sorted(CHAINS))
def test_chain_kernels_match_plain(which, shape, monkeypatch):
    """One launch per chain (3xTF32 wgmma), equal to the plain version within 5e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the chain kernels are CUDA C++ with no CPU mode")
    wrapper, plain, sizes, k = CHAINS[which]
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(np.float32)).cuda()
    args = []
    for ks in sizes:
        args.append(torch.from_numpy((rng.normal(size=(k, ks, ks, C, C)) * (2.0 / (ks * ks * C)) ** 0.5)
                                     .astype(np.float32)).cuda())
        args.append(torch.from_numpy((rng.normal(size=(k, C)) * 0.05).astype(np.float32)).cuda())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # full float32 plain convs
    before = wrapper.launches
    got = wrapper(x, *args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain(x, *args).cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHAIN_SHAPES)
@pytest.mark.parametrize("which", sorted(BLOCKS))
def test_block_kernels_match_plain(which, shape, monkeypatch):
    """One counted call (two launches, 3xTF32 wgmma) per block, equal to the
    plain version within 2e-5, on full 96x96 tiles, small images and ragged crops."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the block kernels are CUDA C++ with no CPU mode")
    wrapper, plain, sizes = BLOCKS[which]
    rng = np.random.default_rng(sum(shape) + 1)
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(np.float32)).cuda()
    args = []
    for ks in sizes:
        args.append(torch.from_numpy((rng.normal(size=(ks, ks, C, C)) * (2.0 / (ks * ks * C)) ** 0.5)
                                     .astype(np.float32)).cuda())
        args.append(torch.from_numpy((rng.normal(size=C) * 0.05).astype(np.float32)).cuda())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # full float32 plain convs
    before = wrapper.launches
    got = wrapper(x, *args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain(x, *args).cpu().numpy(), atol=BLOCK_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(BLOCKS))
def test_block_wrappers_reject_other_channels(which):
    """K1/K2 take C = 128 only on CUDA tensors: C = 64 raises, and nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the check applies to CUDA tensors")
    wrapper, _, sizes = BLOCKS[which]
    c = 64
    args = []
    for ks in sizes:
        args += [torch.zeros(ks, ks, c, c, device="cuda"), torch.zeros(c, device="cuda")]
    before = wrapper.launches
    with pytest.raises(ValueError, match="C == 128"):
        wrapper(torch.zeros(1, 8, 8, c, device="cuda"), *args)
    assert wrapper.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(57, 86), (70, 70), (86, 57), (57, 57), (5, 70), (8, 64)])
@pytest.mark.parametrize("which", ["light53", "light"])
def test_int8_kernels_bit_equal_plain_on_ragged_shapes(which, hw):
    """K4/K5 (s8 wgmma tiles of 4 rows x 64 columns) on images that cut the
    tiles, wider and narrower than one tile, bit-equal to their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 kernels are CUDA C++ with no CPU mode")
    rng = np.random.default_rng(hw[0])
    x = torch.from_numpy((rng.normal(size=(1, *hw, C)) * 0.5).astype(np.float32)).cuda().to(torch.bfloat16)
    args = []
    for k in (3, 5, 5, 3) if which == "light53" else (3, 3):
        q, s = int8_blocks.quantize_weights_per_channel(
            torch.from_numpy((rng.normal(size=(k, k, C, C)) * 0.05).astype(np.float32)).cuda())
        args += [q, s, torch.from_numpy((rng.normal(size=C) * 0.01).astype(np.float32)).cuda()]
    act = torch.tensor([x.float().abs().max().item() / 127, 0.03, 0.05], device="cuda")
    wrapper, plain = {"light53": (int8_blocks.light53_int8, int8_blocks.light53_int8_plain),
                      "light": (int8_blocks.light_int8, int8_blocks.light_int8_plain)}[which]
    act = act if which == "light53" else act[:2].contiguous()
    before = wrapper.launches
    got = wrapper(x, *args, act_scales=act)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, plain(x, *args, act))


# -- the bf16 forms of K1/K2 and K6/K7 ------------------------------------------
#: one bf16 block, or a chain of one, against its plain version (both sum in
#: float32, in other orders within a tap): at most 1e-3 of the elements
#: differ, and no fewer than BF16_MIN_COUNT may (one intermediate that rounds
#: the other way moves a few dozen outputs, over 1e-3 of a 10x6 image), each
#: by one bf16 ulp of its magnitude for a block and two for a chain, the
#: magnitude counted as at least 2^-6 max|ref| for a block and res * max|ref|
#: for a chain (bf16.ulp_gaps, tests/test_torch_bf16.py); a chain of three:
#: max |d| <= 2^-6 max|ref|, mean |d| <= 1e-4 max|ref|
BF16_FRAC, BF16_MIN_COUNT = 1e-3, 64
BF16_NEAR_ZERO, BF16_CHAIN_NEAR_ZERO = 2.0 ** -6, 0.1
BF16_BLOCK_ULPS, BF16_CHAIN_ULPS = 1.0, 2.0
BF16_CHAIN_MAX, BF16_CHAIN_MEAN = 2.0 ** -6, 1e-4


def _bf16_share_ok(frac, got):
    return frac <= max(BF16_FRAC, BF16_MIN_COUNT / got.numel())


def _bf16_inputs(shape, sizes, lead, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(*shape, C)).astype(np.float32)).cuda().to(torch.bfloat16)
    args = []
    for ks in sizes:
        args.append(torch.from_numpy((rng.normal(size=(*lead, ks, ks, C, C)) / np.sqrt(ks * ks * C))
                                     .astype(np.float32)).cuda())
        args.append(torch.from_numpy((rng.normal(size=(*lead, C)) * 0.05).astype(np.float32)).cuda())
    return x, args


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHAIN_SHAPES)
@pytest.mark.parametrize("which", sorted(BLOCKS))
def test_bf16_block_kernels_match_plain(which, shape, monkeypatch):
    """One counted bf16 call (two launches, bf16 wgmma) per block against the
    plain bf16 version, on full 96x96 tiles, small images and ragged crops."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the block kernels are CUDA C++ with no CPU mode")
    from image_enhance_keras_tpu_torch.ops.cuda import bf16

    wrapper, plain, sizes = BLOCKS[which]
    x, args = _bf16_inputs(shape, sizes, (), sum(shape) + 2)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)  # full float32 plain sums
    before, before_bf16 = wrapper.launches, wrapper.bf16_launches
    got = wrapper(x, *args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and wrapper.bf16_launches == before_bf16 + 1
    assert got.dtype == torch.bfloat16
    frac, ulps = bf16.ulp_gaps(got, plain(x, *args), BF16_NEAR_ZERO)
    print(f"bf16 {which} block {shape}: {frac:.3g} of elements differ, largest gap {ulps:.3g} ulp")
    assert _bf16_share_ok(frac, got) and ulps <= BF16_BLOCK_ULPS


@pytest.mark.cuda
@pytest.mark.parametrize("k_blocks", [1, 3])
@pytest.mark.parametrize("shape", CHAIN_SHAPES)
@pytest.mark.parametrize("which", sorted(CHAINS))
def test_bf16_chain_kernels_match_plain(which, shape, k_blocks, monkeypatch):
    """One bf16 launch per chain against the plain bf16 chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the chain kernels are CUDA C++ with no CPU mode")
    from image_enhance_keras_tpu_torch.ops.cuda import bf16

    wrapper, plain, sizes, _ = CHAINS[which]
    x, args = _bf16_inputs(shape, sizes, (k_blocks,), sum(shape) + k_blocks)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    before = wrapper.bf16_launches
    got = wrapper(x, *args)
    torch.cuda.synchronize()
    assert wrapper.bf16_launches == before + 1 and got.dtype == torch.bfloat16
    want = plain(x, *args)
    if k_blocks == 1:
        frac, ulps = bf16.ulp_gaps(got, want, BF16_CHAIN_NEAR_ZERO)
        print(f"bf16 {which} chain K=1 {shape}: {frac:.3g} of elements differ, largest gap {ulps:.3g} ulp")
        assert _bf16_share_ok(frac, got) and ulps <= BF16_CHAIN_ULPS
        return
    d, ref = (got.float() - want.float()).abs(), want.float().abs().max().item()
    print(f"bf16 {which} chain K=3 {shape}: max |d| {d.max().item():.3g}, mean {d.mean().item():.3g}, "
          f"max|ref| {ref:.3g}")
    assert d.max().item() <= BF16_CHAIN_MAX * ref and d.mean().item() <= BF16_CHAIN_MEAN * ref
