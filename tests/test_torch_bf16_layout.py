"""The bf16 kernels' weight layout and implicit GEMM, modelled in torch on the CPU.

Under the bf16 policy ``csrc/conv_tf32x3.cuh`` runs each conv of the bf16
K1/K2 and K6/K7 as an implicit GEMM on ``wgmma.m64n128k16.f32.bf16.bf16``:
B is the weight tile of one (tap, 16-input-channel step), read from
``bf16.packed`` at the offsets of its descriptor; A is an M tile of 8 rows x
8 columns of the input window, which the kernel stages once per conv as 16
planes of 8 channels ``[row][col][16 bytes]`` and walks per tap by moving the
descriptor's start.  These tests replay that address arithmetic in torch
(float64, the kernel's constants) and hold the sums equal to the
convolution of the bf16 operands; they also hold the packer's cache apart
from the 3xTF32 packer's.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_enhance_keras_tpu_torch.ops.cuda import bf16, tf32x3

# the kernel's tile (conv_tf32x3.cuh): 8 rows, two warpgroups of one 8x8 M tile each
C, TILE_H, MT, WGS, KMAX = 128, 8, 1, 2, 5
TILE_W = 8 * MT * WGS
WIN_H, WIN_W = TILE_H + KMAX - 1, TILE_W + KMAX - 1
PLANE = WIN_H * WIN_W * 16 + 16   # bytes of a plane of 8 channels
PLANES = C // 8
B_TILE = 16 * C * 2               # bytes of a (tap, 16-channel step) weight tile
B_STEP = 32 * 1024                # a tap's 8 tiles: one step of the weight ring
WIN_BYTES = 2 * 8 * PLANE         # the float32 policy's window: a slice's hi and lo planes


def _weights(k, seed, n_blocks=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(n_blocks, k, k, C, C)) * 0.05).astype(np.float32))


def _conv64(x, w):
    return F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                    padding=w.shape[0] // 2).permute(0, 2, 3, 1)


def test_window_and_step_sizes_match_the_float32_policy():
    """A 128-channel bf16 window takes the bytes of one float32 slice's hi
    and lo planes, and a tap's bf16 weights one 32 KB ring step."""
    assert PLANES * PLANE == WIN_BYTES
    assert (C // 16) * B_TILE == B_STEP == C * C * 2


def test_packed_rounds_to_nearest_even():
    one = 1.0
    ties = torch.tensor([one + 2 ** -8, one + 3 * 2 ** -8, -(one + 2 ** -8), one + 2 ** -9, 0.1])
    w = torch.zeros(1, 1, C, C)
    w[0, 0, :5, 0] = ties
    got = bf16.packed(w).reshape(-1)
    # (ci, co = 0): tile ci // 16, half (ci % 16) // 8, element ci % 8 of output channel 0
    want = torch.tensor([1.0, one + 2 ** -6, -1.0, 1.0, 0.10009765625])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[:5].float(), want)


@pytest.mark.parametrize("k,stacked", [(3, True), (5, True), (3, False), (5, False)],
                         ids=["3", "5", "block-3", "block-5"])
def test_packed_tile_read_at_kernel_offsets(k, stacked):
    """Every weight at the byte offset produce and the B descriptor give it:
    block kb, tap, 16-channel step ci // 16, the K half (ci % 16) // 8 at
    lbo = C*16, output channel co at co*16, input channel ci % 8 at 2 bytes
    each.  One block's (k, k, C, C) weights (K1/K2) pack as the K = 1 slice
    of the stacked chain layout (K6/K7)."""
    w = _weights(k, k, n_blocks=2) if stacked else _weights(k, k)[0]
    p = bf16.packed(w)
    flat = p.reshape(-1)
    want = w.to(torch.bfloat16)
    if not stacked:
        assert p.shape == (k * k, C // 16, 2, C, 8)
        assert torch.equal(p, bf16.packed(w[None])[0])
        want = want[None]
    kb, ky, kx, ci, co = torch.meshgrid(*(torch.arange(s) for s in want.shape), indexing="ij")
    tap = kb * k * k + ky * k + kx
    assert torch.equal(tap * B_STEP, tap * (C // 16) * B_TILE)  # produce: tap * SLICES * B_STEP
    off = (tap * (C // 16) + ci // 16) * B_TILE + (ci % 16) // 8 * C * 16 + co * 16 + ci % 8 * 2
    assert torch.equal(flat[off // 2], want)
    assert torch.equal(torch.sort(off.reshape(-1) // 2).values, torch.arange(flat.numel()))


def _window(x, n, y0, x0, k):
    """The staged window as the kernel's shared memory, one bf16 value per
    2 bytes (held as float64): plane g holds channels 8g..8g+7 of every
    pixel at (row * WIN_W + col) * 16 bytes; zeros outside the image."""
    _, h, w, _ = x.shape
    p = k // 2
    xb = x.to(torch.bfloat16).double()
    smem = torch.zeros(PLANES * PLANE // 2, dtype=torch.float64)
    for r in range(TILE_H + k - 1):
        gy = y0 - p + r
        for col in range(TILE_W + k - 1):
            gx = x0 - p + col
            if not (0 <= gy < h and 0 <= gx < w):
                continue
            for g in range(PLANES):
                base = (g * PLANE + (r * WIN_W + col) * 16) // 2
                smem[base:base + 8] = xb[n, gy, gx, 8 * g:8 * g + 8]
    return smem


def _implicit_gemm(x, w):
    """SAME conv by the bf16 policy's implicit GEMM: per thread block (8 rows
    x TILE_W columns), tap and 16-channel step kk, D[64, C] += A[64, 16] @
    B[16, C] for each M tile, with A and B read through the descriptors'
    address arithmetic (start, leading byte offset between the K halves,
    stride byte offset between 8-row groups)."""
    n_img, h, wd, _ = x.shape
    k = int(w.shape[0])
    bflat = bf16.packed(w).reshape(-1).double()
    m, kq, nn = torch.arange(64), torch.arange(16), torch.arange(C)
    out = torch.zeros(n_img, h, wd, C, dtype=torch.float64)
    for n in range(n_img):
        for y0 in range(0, h, TILE_H):
            for x0 in range(0, wd, TILE_W):
                smem = _window(x, n, y0, x0, k)
                d = torch.zeros(MT * WGS, 64, C, dtype=torch.float64)
                for tap in range(k * k):
                    ky, kx = divmod(tap, k)
                    for kk in range(C // 16):
                        # desc(b, C * 16, 128) over the step's tile kk
                        b_addr = ((tap * (C // 16) + kk) * B_TILE + (nn // 8) * 128 + (nn % 8) * 16
                                  + (kq[:, None] // 8) * C * 16 + (kq[:, None] % 8) * 2)
                        b = bflat[b_addr // 2]
                        for mt in range(MT * WGS):
                            # desc(a, PLANE, WIN_W * 16) from conv's start address
                            start = 2 * kk * PLANE + (ky * WIN_W + 8 * mt + kx) * 16
                            a_addr = (start + (m[:, None] // 8) * WIN_W * 16 + (m[:, None] % 8) * 16
                                      + (kq // 8) * PLANE + (kq % 8) * 2)
                            d[mt] += smem[a_addr // 2] @ b
                # M row mm of M tile mt is pixel (mm // 8, 8 mt + mm % 8)
                for mt in range(MT * WGS):
                    for mm in range(64):
                        y, xx = y0 + mm // 8, x0 + 8 * mt + mm % 8
                        if y < h and xx < wd:
                            out[n, y, xx] = d[mt, mm]
    return out


@pytest.mark.parametrize("k,hw", [(3, (9, 35)), (5, (9, 35)), (5, (3, 7))])
def test_implicit_gemm_equals_bf16_conv(k, hw):
    rng = np.random.default_rng(k + hw[1])
    x = torch.from_numpy(rng.normal(size=(1, *hw, C)).astype(np.float32))
    w = _weights(k, 7 * k)[0]
    got = _implicit_gemm(x, w)
    want = _conv64(x.to(torch.bfloat16), w.to(torch.bfloat16))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    # the plain versions' conv (per tap, float64 sums) is the same function
    exact = bf16.conv_exact(x.to(torch.bfloat16), w, torch.float64)
    torch.testing.assert_close(exact, want.float(), rtol=0, atol=1e-6)


def test_packs_of_the_two_policies_never_serve_each_other():
    """The 3xTF32 and the bf16 packs of one weight tensor are cached apart:
    each call gets its own policy's pack, however the calls interleave, and
    an in-place change repacks both."""
    w = _weights(3, 4)[0].clone()
    t1 = tf32x3.packed(w)
    b1 = bf16.packed(w)
    assert t1.dtype == torch.float32 and t1.shape == (9, C // 8, 2, 2, C, 4)
    assert b1.dtype == torch.bfloat16 and b1.shape == (9, C // 16, 2, C, 8)
    assert tf32x3.packed(w) is t1 and bf16.packed(w) is b1
    assert w._iek_packed[1] is t1 and w._iek_packed_bf16[1] is b1
    w.mul_(0.5)
    t2, b2 = bf16.packed(w), tf32x3.packed(w)  # the other order
    assert t2.dtype == torch.bfloat16 and b2.dtype == torch.float32
    assert t2 is not b1 and b2 is not t1
    assert torch.equal(t2, bf16.packed(w.clone())) and torch.equal(b2, tf32x3.packed(w.clone()))
