"""The float32 kernels' 3xTF32 weight layout and implicit GEMM, modelled in torch on the CPU.

``csrc/conv_tf32x3.cuh`` runs each float32 conv of K1/K2 and K6/K7 as an
implicit GEMM on ``wgmma.m64n128k8.f32.tf32.tf32``: B is the weight tile of
one (tap, 8-input-channel step), hi then lo, read from ``tf32x3.packed`` at
the offsets of its descriptor; A is an M tile of 8 rows x 8 columns of the input window,
which the kernel stages one 32-channel slice at a time as hi and lo planes of
4 channels ``[row][col][16 bytes]`` and walks per tap by moving the
descriptor's start.  These tests replay that address arithmetic in torch
(float64, same constants as the kernel) and hold the sums equal to the
convolution of the split operands; the kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_enhance_keras_tpu_torch.ops.cuda import tf32x3, tower

# the kernel's tile (conv_tf32x3.cuh): 8 rows, two warpgroups of one 8x8 M tile each
C, TILE_H, MT, WGS, KMAX = 128, 8, 1, 2, 5
TILE_W = 8 * MT * WGS
WIN_H, WIN_W = TILE_H + KMAX - 1, TILE_W + KMAX - 1
CS, PL = 32, 8
PLANE = WIN_H * WIN_W * 16 + 16
B_HALF = 8 * C * 4
B_TILE = 2 * B_HALF


def _weights(k, seed, n_blocks=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(n_blocks, k, k, C, C)) * 0.05).astype(np.float32))


def _conv(x, w):
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=w.shape[0] // 2).permute(0, 2, 3, 1)


def _split_conv(x, w):
    """lo*Whi + hi*Wlo + hi*Whi in float64: the products the kernel sums."""
    xh, xl = tower.split_tf32(x)
    wh, wl = tower.split_tf32(w)
    xh, xl, wh, wl = (t.double() for t in (xh, tower.round_tf32(xl), wh, tower.round_tf32(wl)))
    return _conv(xl, wh) + _conv(xh, wl) + _conv(xh, wh)


def test_round_tf32_keeps_ten_mantissa_bits_and_rounds_to_nearest():
    v = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -12, 0.0])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10), 1.0 + 2 ** -10, 0.0])
    assert torch.equal(tower.round_tf32(v), want)


@pytest.mark.parametrize("k,stacked", [(3, True), (5, True), (3, False), (5, False)],
                         ids=["3", "5", "block-3", "block-5"])
def test_packed_tile_read_at_kernel_offsets(k, stacked):
    """Every float of the packed weights at the byte offset load_b and the B
    descriptor give it: block kb, tap, 8-channel step ci // 8, hi or lo, the
    K half (ci % 8) // 4 at lbo = C*16, output channel co at co*16.  One
    block's (k, k, C, C) weights (K1/K2) pack as the K = 1 slice of the
    stacked chain layout (K6/K7)."""
    w = _weights(k, k, n_blocks=2) if stacked else _weights(k, k)[0]
    p = tf32x3.packed(w)
    flat = p.reshape(-1)
    hi, lo = tower.split_tf32(w)
    if not stacked:
        assert p.shape == (k * k, C // 8, 2, 2, C, 4)
        assert torch.equal(p, tf32x3.packed(w[None])[0])
        hi, lo = hi[None], lo[None]
    kb, ky, kx, ci, co = torch.meshgrid(*(torch.arange(s) for s in hi.shape), indexing="ij")
    tile = ((kb * k * k + ky * k + kx) * (C // 8) + ci // 8)
    off = (tile * B_TILE + (ci % 8) // 4 * C * 16 + co * 16 + ci % 4 * 4) // 4
    assert torch.equal(flat[off], hi)
    assert torch.equal(flat[off + B_HALF // 4], tower.round_tf32(lo))
    assert torch.equal(torch.sort(torch.cat([off.reshape(-1), off.reshape(-1) + B_HALF // 4])).values,
                       torch.arange(flat.numel()))


def _window(x, n, y0, x0, k, sl):
    """Slice sl of the staged window as the kernel's shared memory, in floats:
    hi planes, then lo planes, PLANE bytes each; zeros outside the image."""
    _, h, w, _ = x.shape
    p = k // 2
    hi, lo = tower.split_tf32(x)
    lo = tower.round_tf32(lo)
    smem = torch.zeros(2 * PL * PLANE // 4, dtype=torch.float64)
    for r in range(TILE_H + k - 1):
        gy = y0 - p + r
        for col in range(TILE_W + k - 1):
            gx = x0 - p + col
            if not (0 <= gy < h and 0 <= gx < w):
                continue
            for g in range(PL):
                base = (g * PLANE + (r * WIN_W + col) * 16) // 4
                chans = slice(sl * CS + 4 * g, sl * CS + 4 * g + 4)
                smem[base:base + 4] = hi[n, gy, gx, chans].double()
                smem[base + PL * PLANE // 4:base + PL * PLANE // 4 + 4] = lo[n, gy, gx, chans].double()
    return smem


def _implicit_gemm(x, w):
    """SAME conv by the kernel's implicit GEMM: per thread block (8 rows x
    TILE_W columns), slice, tap and 8-channel step, D[64, C] += A[64, 8] @
    B[8, C] for each M tile and each of the three products, with A and B read
    through the descriptors' address arithmetic (start, leading byte offset
    between the K halves, stride byte offset between 8-row groups)."""
    n_img, h, wd, _ = x.shape
    k = int(w.shape[0])
    bflat = tf32x3.packed(w).reshape(-1).double()
    m, kq, nn = torch.arange(64), torch.arange(8), torch.arange(C)
    out = torch.zeros(n_img, h, wd, C, dtype=torch.float64)
    for n in range(n_img):
        for y0 in range(0, h, TILE_H):
            for x0 in range(0, wd, TILE_W):
                d = torch.zeros(MT * WGS, 64, C, dtype=torch.float64)
                for sl in range(C // CS):
                    smem = _window(x, n, y0, x0, k, sl)
                    for tap in range(k * k):
                        ky, kx = divmod(tap, k)
                        for kk in range(CS // 8):
                            tile = tap * (C // 8) + sl * (CS // 8) + kk
                            b_addr = (tile * B_TILE + (nn // 8) * 128 + (nn % 8) * 16
                                      + (kq[:, None] // 4) * C * 16 + (kq[:, None] % 4) * 4)
                            b_hi, b_lo = bflat[b_addr // 4], bflat[(b_addr + B_HALF) // 4]
                            for mt in range(MT * WGS):
                                start = 2 * kk * PLANE + (ky * WIN_W + 8 * mt + kx) * 16
                                a_addr = (start + (m[:, None] // 8) * WIN_W * 16 + (m[:, None] % 8) * 16
                                          + (kq // 4) * PLANE + (kq % 4) * 4)
                                a_hi, a_lo = smem[a_addr // 4], smem[(a_addr + PL * PLANE) // 4]
                                d[mt] += a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
                # M row mm of M tile mt is pixel (mm // 8, 8 mt + mm % 8)
                for mt in range(MT * WGS):
                    for mm in range(64):
                        y, xx = y0 + mm // 8, x0 + 8 * mt + mm % 8
                        if y < h and xx < wd:
                            out[n, y, xx] = d[mt, mm]
    return out


@pytest.mark.parametrize("k,hw", [(3, (9, 35)), (5, (9, 35)), (5, (3, 7))])
def test_implicit_gemm_equals_split_conv(k, hw):
    rng = np.random.default_rng(k + hw[1])
    x = torch.from_numpy(rng.normal(size=(1, *hw, C)).astype(np.float32))
    w = _weights(k, 7 * k)[0]
    got = _implicit_gemm(x, w)
    want = _split_conv(x, w)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    # and the split products are float32-accurate against the float64 conv
    exact = _conv(x.double(), w.double())
    assert (got - exact).abs().max().item() < 1e-5


def test_fragment_lands_on_its_pixel():
    """stage_acc: d[j][i] of thread t holds M row 16*(t%128//32) + (t%32)//4 +
    8*((i//2)%2) and column 8*(i//4) + 2*(t%4) + i%2 (the wgmma fragment); it
    is written at pixel (M row // 8, 8*(MT*warpgroup + j) + M row % 8)."""
    seen = set()
    for t in range(128 * WGS):
        lane, warp, wg = t % 32, t % 128 // 32, t // 128
        for j in range(MT):
            for i in range(64):
                n8, h, e = i // 4, (i // 2) % 2, i % 2
                row_m = 16 * warp + lane // 4 + 8 * h
                col_n = 8 * n8 + 2 * (lane % 4) + e
                p = (2 * warp + h) * TILE_W + wg * MT * 8 + lane // 4 + 8 * j  # stage_acc
                ch = n8 * 8 + (lane & 3) * 2 + e
                assert divmod(p, TILE_W) == (row_m // 8, 8 * (MT * wg + j) + row_m % 8)
                assert ch == col_n
                seen.add((p, ch))
    assert len(seen) == TILE_H * TILE_W * C


def test_packed_is_cached_until_the_weights_change():
    w = _weights(3, 1)
    first = tf32x3.packed(w)
    assert tf32x3.packed(w) is first
    w.mul_(2.0)  # an in-place change bumps the version: repacked
    again = tf32x3.packed(w)
    assert again is not first
    assert torch.equal(again, tf32x3.packed(w.clone()))


def test_packed_block_weights_are_cached_on_the_tensor_until_they_change():
    """One block's (k, k, C, C) weights (K1/K2) are packed once and cached on
    the weight tensor itself, as the stacked chain weights are."""
    w = _weights(5, 2)[0].clone()
    first = tf32x3.packed(w)
    assert tf32x3.packed(w) is first and w._iek_packed[1] is first
    w.add_(1.0)  # an in-place change bumps the version: repacked
    again = tf32x3.packed(w)
    assert again is not first
    assert torch.equal(again, tf32x3.packed(w.clone()))
