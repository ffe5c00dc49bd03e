"""The port's CUDA kernels on the card (marked ``cuda``; each skips without one).

Imports no JAX, so it runs on a machine that has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the other tests.)
"""

import numpy as np
import pytest
import torch

from image_enhance_keras_tpu_torch.ops.cuda import blocks, int8_blocks, int8_xla, tower, upsample
from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_plain

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


#: (H, W), tile of the int8 kernels' dynamic form: one 96x96 patch (two 48x96
#: windows), ragged crops, tiles of 8 (many windows, rings wider than a
#: window), and a window narrower than one 64-column conv tile
INT8_DYNAMIC_CASES = [((96, 96), (64, 128)), ((57, 86), (64, 128)), ((13, 21), (8, 8)),
                      ((40, 24), (8, 16)), ((5, 70), (64, 128)), ((86, 57), (16, 24))]


def _int8_inputs(which, hw, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(2, *hw, C)) * 0.5).astype(np.float32)).cuda().to(dtype)
    args = []
    for k in (3, 5, 5, 3) if which == "light53" else (3, 3):
        q, s = int8_blocks.quantize_weights_per_channel(
            torch.from_numpy((rng.normal(size=(k, k, C, C)) * 0.05).astype(np.float32)).cuda())
        args += [q, s, torch.from_numpy((rng.normal(size=C) * 0.01).astype(np.float32)).cuda()]
    return x, args


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", INT8_DYNAMIC_CASES)
@pytest.mark.parametrize("which", ["light53", "light"])
def test_int8_dynamic_kernels_bit_equal_plain(which, case, dtype):
    """K4/K5 with per-window dynamic scales (three launches over the TPU's
    windows), bf16 and float32 x, bit-equal to the plain versions, which
    quantize over the same windows; a spike in the columns only the input
    abs-max spans (right of what the convs read) must move the result as it
    moves the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 kernels are CUDA C++ with no CPU mode")
    hw, tile = case
    x, args = _int8_inputs(which, hw, dtype, hw[0] + hw[1])
    wrapper, plain = {"light53": (int8_blocks.light53_int8, int8_blocks.light53_int8_dynamic_plain),
                      "light": (int8_blocks.light_int8, int8_blocks.light_int8_dynamic_plain)}[which]
    th, tw, _, _ = int8_blocks.window_grid(*hw, tile)
    col = tw + (4 if which == "light53" else 5)  # read by window 0's abs-max, not by its convs
    if col < hw[1]:
        x[0, 0, col] = 40.0
    before = wrapper.launches
    got = wrapper(x, *args, tile=tile)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and got.dtype == dtype
    want = plain(x, *args, tile)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["light53", "light"])
def test_int8_dynamic_kernels_divide_at_ties(which):
    """One window whose input values sit on exact ties of its dynamic scale
    ((k + 1/2) * s): the kernels' codes divide (round half to even), as the
    plain versions' do, where a product with 1/s lands off some ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 kernels are CUDA C++ with no CPU mode")
    rng = np.random.default_rng(11)
    amax = np.float32(1.2345678)
    s = np.float32(amax * np.float32(1.0 / 127.0))
    k = rng.integers(-126, 126, 8 * 8 * C).astype(np.float32)
    xn = ((k + np.float32(0.5)) * s).astype(np.float32)
    xn[0] = amax
    assert (np.round(xn / s) != np.round(xn * (np.float32(1) / s))).any()
    x = torch.from_numpy(xn.reshape(1, 8, 8, C)).cuda()
    _, args = _int8_inputs(which, (8, 8), torch.float32, 12)
    wrapper, plain = {"light53": (int8_blocks.light53_int8, int8_blocks.light53_int8_dynamic_plain),
                      "light": (int8_blocks.light_int8, int8_blocks.light_int8_dynamic_plain)}[which]
    assert torch.equal(wrapper(x, *args, tile=(8, 8)), plain(x, *args, (8, 8)))


#: (H, W), tile whose windows' rings are not multiples of 64 columns: 128
#: columns (rings of 132 / 130: one raster segment at the widest pitch), 200
#: (rings of 204 / 202: two segments), 56 with 8-row windows (rings of 60 / 58)
INT8_DYNAMIC_RING_CASES = [((24, 128), (24, 128)), ((30, 200), (32, 200)), ((17, 52), (8, 56))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", INT8_DYNAMIC_RING_CASES)
@pytest.mark.parametrize("which", ["light53", "light"])
def test_int8_dynamic_kernels_bit_equal_plain_on_ring_widths(which, case, dtype):
    """The dynamic ring launch (M tiles in raster order over ring segments,
    rings stored through shared memory, then requantized to codes) at rings
    that no 64-column tile fits, bit-equal to the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 kernels are CUDA C++ with no CPU mode")
    hw, tile = case
    x, args = _int8_inputs(which, hw, dtype, hw[0] * 7 + hw[1])
    wrapper, plain = {"light53": (int8_blocks.light53_int8, int8_blocks.light53_int8_dynamic_plain),
                      "light": (int8_blocks.light_int8, int8_blocks.light_int8_dynamic_plain)}[which]
    before = wrapper.launches
    got = wrapper(x, *args, tile=tile)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain(x, *args, tile)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(57, 86), (70, 70), (5, 70), (8, 64)])
@pytest.mark.parametrize("which", ["light53", "light"])
def test_int8_static_kernels_float32_bit_equal_plain(which, hw):
    """K4/K5 with calibrated scales on float32 x (two epilogue passes of 64
    channels), bit-equal to the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 kernels are CUDA C++ with no CPU mode")
    x, args = _int8_inputs(which, hw, torch.float32, hw[0])
    act = torch.tensor([x.abs().max().item() / 127, 0.03, 0.05], device="cuda")
    wrapper, plain = {"light53": (int8_blocks.light53_int8, int8_blocks.light53_int8_plain),
                      "light": (int8_blocks.light_int8, int8_blocks.light_int8_plain)}[which]
    act = act if which == "light53" else act[:2].contiguous()
    got = wrapper(x, *args, act_scales=act)
    assert got.dtype == torch.float32
    assert torch.equal(got, plain(x, *args, act))


# -- X1-X3, the XLA int8 forward's blocks (per-channel static, per-sample dynamic) --
#: (N, H, W): a batch of 96x96 patches, ragged crops that cut the 4 x 64 tiles,
#: an image narrower than one tile, "big": codes and weights near 127,
#: whose sums pass 2^24 (the bf16 accumulator then rounds twice), and more
#: tiles than the card's SMs, so that each persistent block walks several:
#: (4, 96, 96) in raster tiles (X1's first launch, X2) and 4 x 64 ones (X1's
#: second), (1, 128, 384) in 4 x 64 tiles
INT8_XLA_SHAPES = [(2, 96, 96), (1, 57, 86), (1, 86, 57), (1, 5, 70), (2, 8, 64), "big", (4, 96, 96), (1, 128, 384)]
INT8_XLA = {"light53": (int8_xla.light53_int8_xla, int8_xla.light53_int8_xla_plain, (3, 5, 5, 3), 3),
            "light": (int8_xla.light_int8_xla, int8_xla.light_int8_xla_plain, (3, 3), 2),
            "light53_dyn": (int8_xla.light53_int8_xla_dyn, int8_xla.light53_int8_xla_dyn_plain, (3, 5, 5, 3), 0)}


def _int8_xla_inputs(which, shape, seed):
    """bf16 x, per conv (int8 weights, float32 scales, biases), and (k, C) scale vectors."""
    rng = np.random.default_rng(seed)
    big = shape == "big"
    shape = (1, 24, 70) if big else shape
    if big:  # every channel at its scale's 127 code, positive weights near 127
        x = np.full((*shape, C), 1.0, np.float32) + rng.random((*shape, C)).astype(np.float32) * 0.05
    else:  # channels of different ranges, as per-channel calibration sees them
        x = rng.normal(size=(*shape, C)).astype(np.float32) * np.exp(rng.normal(size=C)).astype(np.float32) * 0.3
    x = torch.from_numpy(x).cuda().to(torch.bfloat16)
    args = []
    for k in INT8_XLA[which][2]:
        if big:
            q = torch.from_numpy(rng.integers(100, 128, (k, k, C, C)).astype(np.int8)).cuda()
            s = torch.from_numpy((rng.random(C) * 1e-7 + 1e-8).astype(np.float32)).cuda()
        else:
            q, s = int8_blocks.quantize_weights_per_channel(
                torch.from_numpy((rng.normal(size=(k, k, C, C)) * 0.05).astype(np.float32)).cuda())
        args += [q, s, torch.from_numpy((rng.normal(size=C) * 0.01).astype(np.float32)).cuda()]
    amax = x.float().abs().amax(dim=(0, 1, 2))
    rows = [amax / (127.0 if big else 100.0)]  # the input's scales clip a few codes unless "big"
    rows += [torch.from_numpy((0.02 + 0.03 * rng.random(C)).astype(np.float32)).cuda()
             for _ in range(INT8_XLA[which][3] - 1)]
    return x, args, torch.stack(rows).contiguous() if INT8_XLA[which][3] else None


@pytest.mark.cuda
@pytest.mark.parametrize("acc", ["bf16", "s32"])
@pytest.mark.parametrize("shape", INT8_XLA_SHAPES)
@pytest.mark.parametrize("which", sorted(INT8_XLA))
def test_int8_xla_kernels_bit_equal_plain(which, shape, acc):
    """X1/X2 (two launches) and X3 (three) on s8 wgmma, one counted call each,
    bit-equal to their plain versions in both accumulator modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 kernels are CUDA C++ with no CPU mode")
    wrapper, plain, _, n_act = INT8_XLA[which]
    x, args, act = _int8_xla_inputs(which, shape, len(str(shape)) + len(which))
    extra = (act,) if n_act else ()
    before = wrapper.launches
    got = wrapper(x, *args, *extra, acc=acc)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and got.dtype == torch.bfloat16
    want = plain(x, *args, *extra, acc=acc)
    assert torch.equal(got, want), ((got.float() - want.float()).abs().max().item(),
                                    (got != want).float().mean().item())


@pytest.mark.cuda
def test_int8_scales_divide_on_the_card_as_on_the_cpu():
    """The plain versions' divisions by 127 (per-channel weight scales,
    per-sample dynamic scales) give the CPU's quotients on CUDA tensors too
    (torch's CUDA division by a Python scalar multiplies by its reciprocal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(23)
    w = torch.from_numpy((rng.normal(size=(3, 3, 4, 4096)) * np.exp(rng.normal(size=4096))).astype(np.float32))
    for got, want in zip(int8_blocks.quantize_weights_per_channel(w.cuda()),
                         int8_blocks.quantize_weights_per_channel(w)):
        assert torch.equal(got.cpu(), want)
    t = torch.from_numpy((rng.random((4096, 2, 2, 1)) * np.exp(rng.normal(size=(4096, 1, 1, 1)))).astype(np.float32))
    for got, want in zip(int8_xla._quant_dyn_sample(t.cuda()), int8_xla._quant_dyn_sample(t)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(INT8_XLA))
def test_int8_xla_wrappers_reject_what_the_kernels_do_not_take(which):
    """float32 x, and C other than 128, raise on CUDA tensors, with no launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    wrapper, _, _, n_act = INT8_XLA[which]
    x, args, act = _int8_xla_inputs(which, (1, 8, 8), 3)
    extra = (act,) if n_act else ()
    before = wrapper.launches
    with pytest.raises(TypeError, match="bfloat16"):
        wrapper(x.float(), *args, *extra)
    with pytest.raises(ValueError, match="C == 128"):
        c = 16
        sub = [a[..., :c, :c].contiguous() if a.dim() == 4 else a[:c].contiguous() for a in args]
        wrapper(x[..., :c].contiguous(), *sub, *((act[:, :c].contiguous(),) if n_act else ()))
    assert wrapper.launches == before


# -- K3, the TF1 phase upsample ----------------------------------------------------
#: (N, H, W): ragged shapes (odd sides, a width that no block of pixels divides)
UPSAMPLE_SHAPES = [(1, 5, 7), (2, 13, 21), (1, 57, 86)]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 128])
@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("factor", [2, 3, 4, 5])
def test_upsample_kernel_bit_equal_plain(factor, dtype, shape, c):
    """K3 (the unrolled forms f = 2, 3, 4, the loop form at 5) bit-equal to
    upsample_phase_plain; one counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the upsample kernel is CUDA C++ with no CPU mode")
    rng = np.random.default_rng(sum(shape) + factor + c)
    x = torch.from_numpy((rng.normal(size=(*shape, c)) * 3).astype(np.float32)).cuda().to(dtype)
    before = upsample.upsample_phase_tf1_kernel.launches
    before_bf16 = upsample.upsample_phase_tf1_kernel.bf16_launches
    got = upsample.upsample_phase_tf1_kernel(x, factor)
    torch.cuda.synchronize()
    assert upsample.upsample_phase_tf1_kernel.launches == before + 1
    assert upsample.upsample_phase_tf1_kernel.bf16_launches == before_bf16 + int(dtype == torch.bfloat16)
    assert got.dtype == dtype and tuple(got.shape) == (shape[0], factor * shape[1], factor * shape[2], c)
    want = upsample_phase_plain(x, factor)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


# -- K3q and X1u: IEK_INT8_UPQ's fused x4 and first HR block ----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 128])
@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES)
@pytest.mark.parametrize("factor", [2, 4, 5])
def test_upsample_quant_kernel_bit_equal_plain(factor, shape, c):
    """K3q: the bf16 x4 with the per-channel int8 quantize in its epilogue,
    bit-equal to upsample_quant_plain (codes that clip at +-127 included);
    one counted launch, no K3 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the upsample kernel is CUDA C++ with no CPU mode")
    rng = np.random.default_rng(sum(shape) + factor + c + 1)
    x = torch.from_numpy((rng.normal(size=(*shape, c)) * 3).astype(np.float32)).cuda().to(torch.bfloat16)
    s = torch.from_numpy((np.exp(rng.normal(size=c)) * 0.03).astype(np.float32)).cuda()
    before, before_k3 = upsample.upsample_quant_tf1.launches, upsample.upsample_phase_tf1_kernel.launches
    got = upsample.upsample_quant_tf1(x, factor, s)
    torch.cuda.synchronize()
    assert upsample.upsample_quant_tf1.launches == before + 1
    assert upsample.upsample_phase_tf1_kernel.launches == before_k3
    assert got.dtype == torch.int8 and tuple(got.shape) == (shape[0], factor * shape[1], factor * shape[2], c)
    want = upsample.upsample_quant_plain(x, factor, s)
    assert torch.equal(got, want), (got.int() - want.int()).abs().max().item()
    assert want.abs().max().item() == 127  # the clip is exercised


@pytest.mark.cuda
@pytest.mark.parametrize("acc", ["bf16", "s32"])
@pytest.mark.parametrize("shape,factor", [((2, 24, 24), 4), ((1, 5, 70), 4), ("big", 4), ((1, 7, 33), 2)])
def test_int8_xla_upq_kernel_bit_equal_plain(shape, factor, acc):
    """X1u (the int8 codes of the bf16 x f of the LR map h_lr, and h_lr, from
    which it forms its float32 skip; bf16 out), one counted call and no K3
    launch, bit-equal to its plain version: at an LR -> HR map, at a stripe
    whose last LR row clamps and whose x4 ends in a ragged column tile (5 x
    70 -> 20 x 280), with the codes at +-127 ("big"), and at f = 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 kernels are CUDA C++ with no CPU mode")
    h, args, act = _int8_xla_inputs("light53", shape, 31 + len(str(shape)))
    xq = upsample.upsample_quant_tf1(h, factor, act[0].contiguous())
    before, before_k3 = int8_xla.light53_int8_xla_upq.launches, upsample.upsample_phase_tf1_kernel.launches
    got = int8_xla.light53_int8_xla_upq(xq, h, *args, act[1:].contiguous(), acc=acc)
    torch.cuda.synchronize()
    assert int8_xla.light53_int8_xla_upq.launches == before + 1
    assert upsample.upsample_phase_tf1_kernel.launches == before_k3
    assert got.dtype == torch.bfloat16 and got.shape == xq.shape
    want = int8_xla.light53_int8_xla_upq_plain(xq, h, *args, act[1:].contiguous(), acc=acc, factor=factor)
    assert torch.equal(got, want), ((got.float() - want.float()).abs().max().item(),
                                    (got != want).float().mean().item())


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
#: a chain of 16 against its plain version: within this many times the gap
#: between the plain version summed in float64 and in float32, in mean and
#: in max (chip_smoke.py's bound for the didbl tower's chains)
BF16_YARDSTICK_TIMES = 2.0
#: shapes for the bf16 tile's (csrc/conv_bf16.cuh) persistent grid of 8 x 16
#: tiles: ragged crops with an odd number of tiles, whose last tiles lie
#: partly outside the image, batches of 2 and 3, and one 96 x 96 image, whose
#: 72 tiles are fewer than the card's SMs
BF16_TILE_SHAPES = [(1, 37, 40), (3, 8, 48), (2, 13, 37), (1, 96, 96)]


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
@pytest.mark.parametrize("shape", CHAIN_SHAPES + BF16_TILE_SHAPES)
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


@pytest.mark.cuda
@pytest.mark.parametrize("k_blocks", [2, 16])
@pytest.mark.parametrize("shape", BF16_TILE_SHAPES)
@pytest.mark.parametrize("which", sorted(CHAINS))
def test_bf16_chain_kernels_deep_on_odd_tile_counts(which, shape, k_blocks, monkeypatch):
    """One bf16 launch per chain of 2 or 16 blocks on the bf16 tile's ragged
    and small shapes: 2 blocks within the bounds of a chain of three, 16 within
    BF16_YARDSTICK_TIMES the float64-vs-float32 gap of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the chain kernels are CUDA C++ with no CPU mode")
    wrapper, plain, sizes, _ = CHAINS[which]
    bf16_plain = tower.light53_chain_bf16 if which == "light53" else tower.light_chain_bf16
    x, args = _bf16_inputs(shape, sizes, (k_blocks,), sum(shape) + 7 * k_blocks)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    before = wrapper.bf16_launches
    got = wrapper(x, *args)
    torch.cuda.synchronize()
    assert wrapper.bf16_launches == before + 1 and got.dtype == torch.bfloat16
    want = plain(x, *args).float()
    d = (got.float() - want).abs()
    if k_blocks == 2:
        ref = want.abs().max().item()
        print(f"bf16 {which} chain K=2 {shape}: max |d| {d.max().item():.3g}, mean {d.mean().item():.3g}")
        assert d.max().item() <= BF16_CHAIN_MAX * ref and d.mean().item() <= BF16_CHAIN_MEAN * ref
        return
    y = (bf16_plain(x, *args, sum_dtype=torch.float64).float() - want).abs()
    print(f"bf16 {which} chain K=16 {shape}: |kernel - plain| mean {d.mean().item():.3g} max {d.max().item():.3g}; "
          f"yardstick mean {y.mean().item():.3g} max {y.max().item():.3g}")
    assert d.mean().item() <= BF16_YARDSTICK_TIMES * y.mean().item()
    assert d.max().item() <= BF16_YARDSTICK_TIMES * y.max().item()


#: split mode's stripes and 2-D tiles on a 40x56 image (halo 3 at n_tail53 = 2)
SPLIT_LAYOUTS = {"stripes": dict(split_tile=16), "tiles": dict(split_tile=16, split_tile_w=24)}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(SPLIT_LAYOUTS))
@pytest.mark.parametrize("forward", ["xla", "pallas_int8"])
def test_split_mode_on_card(forward, layout):
    """Split mode at C = 128 (2 + 1 + 2 blocks, seeded weights): K3 once per stripe or
    tile chunk, K4 twice; byte-equal with the plain x4 (and the plain int8 blocks)
    swapped in; against fast mode within the float32 uint8 bound, int8 within
    JAX's own (3 levels on under 5% of values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the split tails run the CUDA kernels")
    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.models import didbl, didbl_pallas, zoo
    from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble

    small = dict(n_body53=2, n_light=1, n_tail53=2)
    spec = zoo.MODEL_REGISTRY["didbl"]
    img = np.random.default_rng(5).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    fast = SuperResolver(module_and_spec=(DifvdsrDouble(**small), spec), forward=forward, mode="fast")
    split = SuperResolver(module_and_spec=(DifvdsrDouble(**small), spec), forward=forward, mode="split",
                          **SPLIT_LAYOUTS[layout])
    if forward == "pallas_int8":
        split._qparams = fast._fwd_params()
    want = fast.upscale(img)
    tails = {"stripes": 3, "tiles": 2}[layout]  # 40 rows / 16; 3 x 3 tiles: a chunk of 8, then 1
    k3, k4 = upsample.upsample_phase_tf1_kernel, int8_blocks.light53_int8
    before = (k3.launches, k4.launches)
    got = split.upscale(img)
    assert k3.launches - before[0] == tails
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    if forward == "pallas_int8":
        assert k4.launches - before[1] == 2 + 2 * tails
        assert d.max() <= 3 and (d > 0).mean() < 0.05
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3

    def plain53(x, *a, res_scale=0.1, identity_scale=0.9, tile=None, act_scales=None):
        return int8_blocks.light53_int8_plain(x, *a, act_scales, res_scale, identity_scale)

    def plain_light(x, *a, res_scale=0.1, tile=None, act_scales=None):
        return int8_blocks.light_int8_plain(x, *a, act_scales, res_scale)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(didbl, "upsample_phase_tf1", upsample_phase_plain)
        m.setattr(didbl_pallas, "upsample_phase_tf1", upsample_phase_plain)
        m.setattr(didbl_pallas, "light53_int8", plain53)
        m.setattr(didbl_pallas, "light_int8", plain_light)
        assert np.array_equal(split.upscale(img), got)


#: X4's (C_in, C_out) on the zoo's int8 forwards: difv4, difvdsr, the subpixel head
X4_CONVS = [(256, 256), (192, 192), (128, 2048)]
#: small and ragged (N, H, W), one map wider than a 64-column M tile
X4_SHAPES = [(2, 12, 12), (1, 7, 70), (1, 5, 3)]


def _x4_inputs(cin, cout, shape, dtype, seed):
    """x of channels at different ranges, HWIO int8 weights with their scales, biases, s_in."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, cin)).astype(np.float32) * np.exp(rng.normal(size=cin)).astype(np.float32)
    x = torch.from_numpy(x).cuda().to(dtype)
    q, s = int8_blocks.quantize_weights_per_channel(
        torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)).cuda())
    b = torch.from_numpy((rng.normal(size=cout) * 0.01).astype(np.float32)).cuda()
    s_in = x.float().abs().amax(dim=(0, 1, 2)) / 100.0  # clips a few codes
    return x, q, s, b, s_in.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu", 0.2])
@pytest.mark.parametrize("acc", ["bf16", "s32"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", X4_SHAPES)
@pytest.mark.parametrize("conv", X4_CONVS)
def test_int8_conv_kernel_bit_equal_plain(conv, shape, dtype, acc, act):
    """X4 static and dynamic, one counted launch each, bit-equal to their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 conv kernel is CUDA C++ with no CPU mode")
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv

    cin, cout = conv
    x, q, s, b, s_in = _x4_inputs(cin, cout, shape, dtype, cin + cout + sum(shape))
    for wrapper, plain, args in ((int8_conv.int8_conv3, int8_conv.int8_conv3_plain, (q, s, b, s_in)),
                                 (int8_conv.int8_conv3_dyn, int8_conv.int8_conv3_dyn_plain, (q, s, b))):
        before = wrapper.launches
        got = wrapper(x, *args, acc=acc, act=act)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1 and got.dtype == torch.float32
        want = plain(x, *args, acc=acc, act=act)
        assert torch.equal(got, want), (wrapper.__name__, (got - want).abs().max().item(),
                                        (got != want).float().mean().item())


#: (N, H, W) of the block forms: raster tiles (W not a multiple of 64, a
#: 96-wide map), 4 x 64 tiles (W = 128), a sample smaller than a tile
X4_BLOCK_SHAPES = [(2, 12, 12), (1, 6, 96), (1, 9, 128), (1, 5, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("acc", ["bf16", "s32"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", X4_BLOCK_SHAPES)
@pytest.mark.parametrize("c", [256, 192, 64])
def test_int8_conv_block_forms_bit_equal_plain(c, shape, dtype, acc):
    """X4's block forms (codes from x and from codes under every activation,
    LightBlock's conv_b + combine, DiffBlock's conv_b and conv_d + combine),
    one counted launch each, bit-equal to their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 conv kernel is CUDA C++ with no CPU mode")
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    x, q, s, b, s_in = _x4_inputs(c, c, shape, dtype, c + sum(shape))
    s_out = (s_in * 3.0).contiguous()

    def held(wrapper, plain, *args, **kw):
        before = wrapper.launches
        got = wrapper(*args, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        want = plain(*args, **kw)
        for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
            assert g.dtype == w.dtype and torch.equal(g, w), (wrapper.__name__, (g.float() - w.float()).abs().max())
        return got

    for act in (None, "relu", 0.2):
        xq = held(k.int8_conv3_codes, k.int8_conv3_codes_plain, x, q, s, b, s_in, s_out, acc=acc, act=act)
        held(k.int8_conv3_codes, k.int8_conv3_codes_plain, xq, q, s, b, None, s_out, acc=acc, act=act)
    held(k.int8_conv3_light, k.int8_conv3_light_plain, xq, q, s, b, x, acc=acc)
    t, _ = held(k.int8_conv3_diff_b, k.int8_conv3_diff_b_plain, xq, q, s, b, x, s_out, acc=acc)
    held(k.int8_conv3_diff_d, k.int8_conv3_diff_d_plain, xq, q, s, b, x, t, acc=acc)


@pytest.mark.cuda
def test_input_scaling_divides_on_the_card_as_on_the_cpu():
    """The engines' /255 of every uint8 value gives the CPU's quotient on the
    card (a CUDA division by a Python scalar would differ for 126 of them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from image_enhance_keras_tpu_torch.ops.color import im2double

    v = torch.arange(256, dtype=torch.uint8)
    want = im2double(v)
    assert torch.equal(im2double(v.cuda()).cpu(), want)
    assert torch.equal(want, torch.from_numpy(np.arange(256, dtype=np.float32) / np.float32(255.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("factor,shape", [(4, (2, 9, 7, 128)), (2, (2, 9, 7, 256)), (4, (1, 5, 3, 16))])
def test_upsample_gradient_equals_plain_autograd(factor, shape, dtype):
    """K3's autograd wrapper (the training path): its gradient is the plain
    construction's autograd, bit for bit, and the forward launches once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the upsample kernel is CUDA C++ with no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype).requires_grad_(True)
    n, h, w, c = shape
    g = torch.randn((n, factor * h, factor * w, c), generator=gen, device="cuda").to(dtype)
    before = upsample.upsample_phase_tf1_kernel.launches
    (got,) = torch.autograd.grad(upsample.upsample_phase_tf1_kernel(x, factor), x, g)
    (want,) = torch.autograd.grad(upsample_phase_plain(x, factor), x, g)
    torch.cuda.synchronize()
    assert upsample.upsample_phase_tf1_kernel.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_cpu():
    """One narrow didbl train step on the card (K3 forward, plain backward)
    against the same step on the CPU: the loss within rtol 1e-5, each
    gradient leaf within 1e-4 of its largest magnitude, the params within
    1e-6 where the gradient is above Adam's eps region
    (tests/test_torch_train_step.py's bounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the train step's x4 runs on the upsample kernel")
    from image_enhance_keras_tpu_torch.engine import disable_tf32
    from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
    from image_enhance_keras_tpu_torch.models.zoo import init_params
    from image_enhance_keras_tpu_torch.train.trainer import Adam, TrainState, make_train_step, mask_frozen

    disable_tf32()
    batch = np.random.default_rng(3).integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)
    res = {}
    for dev in ("cpu", "cuda"):
        module = init_params(DifvdsrDouble(features=16, n_body53=2, n_light=1, n_tail53=1), 3).to(dev)
        state = TrainState(module, Adam(mask_frozen(module), 1e-4))
        before = upsample.upsample_phase_tf1_kernel.launches
        state, m = make_train_step(4, 0.5)(state, torch.from_numpy(batch).to(dev))
        res[dev] = (float(m["loss"]), {k: p.grad.cpu() for k, p in state.opt.params.items()},
                    {k: v.cpu() for k, v in state.params().items()}, upsample.upsample_phase_tf1_kernel.launches - before)
    (lc, gc, pc, _), (lg, gg, pg, n3) = res["cpu"], res["cuda"]
    assert n3 == 1
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for k, g in gc.items():
        assert float((gg[k] - g).abs().max()) <= 1e-4 * float(g.abs().max()), k
        assert float(torch.where(g.abs() >= 1e-6, (pg[k] - pc[k]).abs(), 0.0).max()) <= 1e-6, k


@pytest.mark.cuda
@pytest.mark.parametrize("acc", ["bf16", "s32"])
@pytest.mark.parametrize("n_bands", [2, 3])
def test_banded_dynamic_steps_bit_equal(n_bands, acc):
    """X3 and X4's dynamic form in steps over bands of rows (their abs-maxes
    reduced between the steps, ``parallel.bands.run_bands``), bit-equal to
    one launch over the sample and to the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 kernels are CUDA C++ with no CPU mode")
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv
    from image_enhance_keras_tpu_torch.parallel.bands import Stage, Weights, run_bands, split_sizes

    rng = np.random.default_rng(n_bands)

    def conv(k, cout=C):
        q, s = int8_blocks.quantize_weights_per_channel(
            torch.from_numpy((rng.normal(size=(k, k, C, cout)) * 0.05).astype(np.float32)))
        return [q.cuda(), s.cuda(), torch.from_numpy((rng.normal(size=cout) * 0.01).astype(np.float32)).cuda()]

    x = torch.from_numpy((rng.normal(size=(1, 37, 70, C)) * 2).astype(np.float32)).to(torch.bfloat16).cuda()
    x3, x4 = [*conv(3), *conv(5), *conv(5), *conv(3)], conv(3, 256)
    cases = [
        (lambda t: int8_xla.light53_int8_xla_dyn(t, *x3, acc=acc),
         lambda t: int8_xla.light53_int8_xla_dyn_plain(t, *x3, acc=acc),
         Stage(lambda w, t, win: int8_xla.light53_int8_xla_dyn_banded(t, win, *x3, acc=acc), 3, banded=True)),
        (lambda t: int8_conv.int8_conv3_dyn(t, *x4, acc=acc, act="relu"),
         lambda t: int8_conv.int8_conv3_dyn_plain(t, *x4, acc=acc, act="relu"),
         Stage(lambda w, t, win: int8_conv.int8_conv3_dyn_banded(t, win, *x4, acc=acc, act="relu"), 1,
               banded=True)),
    ]
    for whole, plain, stage in cases:
        want = whole(x)
        bands = list(torch.split(x, split_sizes(x.shape[1], n_bands), dim=1))
        got = torch.cat(run_bands([stage], bands, [Weights(None, None)] * n_bands), 1)
        assert torch.equal(got, want)
        assert torch.equal(want, plain(x))
    # X3's launches in turn: the requantization pass and the second convs over its codes
    ta, tb, amax_ab = int8_xla.light53_int8_xla_dyn_first_plain(x, *x3[:3], *x3[6:9], int8_xla.sample_absmax(x),
                                                               acc, (0, 37, 0, 70))
    qa, qb = (int8_xla.dyn_requant_plain(t, m) for t, m in zip((ta, tb), amax_ab))
    assert torch.equal(int8_xla.light53_int8_xla_dyn_codes_plain(x, qa, qb, *x3[3:6], *x3[9:], amax_ab, acc, 0.1, 0.9),
                       int8_xla.light53_int8_xla_dyn_plain(x, *x3, acc=acc))
