"""The int8 kernels' weight layout and implicit GEMM, modelled in torch on the CPU.

``csrc/int8_blocks.cu`` runs each s8 conv as an implicit GEMM on
``wgmma.m64n128k32``: B is the weight tile of one (tap, 32-input-channel
step), read from ``_packed`` at the offsets of its descriptor; A is 64
consecutive pixels of one row of the input window, which the kernel stages
as planes of 16 channels ``[row][col][16 bytes]`` and walks per tap by moving
the descriptor's start.  These tests replay that address arithmetic in torch
(same constants as the kernel) and hold the sums equal to the exact
convolution ``_conv_s32``.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as i8

# the kernel's tile: rows of a thread block, columns of an M tile, halo of the
# widest conv, and the plane padding of the staged window
TILE_H, TILE_W, KMAX = 4, 64, 5
WIN_H, WIN_W = TILE_H + KMAX - 1, TILE_W + KMAX - 1
PLANE = WIN_H * WIN_W * 16 + 16


def _weights(k, cin, cout, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8))


def _b_offset(ky, kx, ci, co, k, cin, cout):
    """Byte offset of wq[ky, kx, ci, co] in the packed weights, as the kernel
    reads it: tile s = tap * (cin/32) + ci // 32 at s * cout * 32 (load_b);
    within the tile the K half at lbo = cout * 16, output channel co at co * 16
    (rows of 16 bytes, 8-row groups 128 bytes apart), the channel's byte."""
    tile = (ky * k + kx) * (cin // 32) + ci // 32
    return tile * cout * 32 + (ci % 32) // 16 * cout * 16 + co * 16 + ci % 16


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("c", [32, 64, 128])
def test_packed_round_trips_to_hwio(k, c):
    wq = _weights(k, c, c, k * c)
    p = i8._packed(wq)
    assert tuple(p.shape) == (k * k, c // 32, 2, c, 16) and p.is_contiguous()
    back = p.permute(0, 1, 2, 4, 3).reshape(k, k, c, c)
    assert torch.equal(back, wq)


@pytest.mark.parametrize("k,cin,cout", [(3, 32, 32), (5, 64, 64), (3, 128, 128), (5, 64, 32)])
def test_packed_tile_read_at_kernel_offsets(k, cin, cout):
    wq = _weights(k, cin, cout, 11 * k + cin)
    flat = i8._packed(wq).reshape(-1)
    ky, kx, ci, co = torch.meshgrid(torch.arange(k), torch.arange(k), torch.arange(cin),
                                    torch.arange(cout), indexing="ij")
    off = _b_offset(ky, kx, ci, co, k, cin, cout)
    assert torch.equal(flat[off], wq)
    assert torch.equal(torch.sort(off.reshape(-1)).values, torch.arange(flat.numel()))


def _window(q, n, y0, x0, k):
    """The staged window of one thread block as the kernel's shared memory:
    PLANES planes of PLANE bytes, zeros outside the image and the halo."""
    _, h, w, c = q.shape
    p = k // 2
    smem = torch.zeros(c // 16 * PLANE, dtype=torch.int64)
    for r in range(TILE_H + k - 1):
        gy = y0 - p + r
        if not 0 <= gy < h:
            continue
        for col in range(TILE_W + k - 1):
            gx = x0 - p + col
            if not 0 <= gx < w:
                continue
            for g in range(c // 16):
                base = g * PLANE + (r * WIN_W + col) * 16
                smem[base:base + 16] = q[n, gy, gx, g * 16:(g + 1) * 16]
    return smem


def _implicit_gemm(q, wq):
    """SAME conv of int8 codes by the kernel's implicit GEMM: per thread block
    (4 rows x 64 columns), per tap and 32-channel step, D[64, cout] +=
    A[64, 32] @ B[32, cout] with A and B read through the descriptors'
    address arithmetic (start, leading byte offset, stride byte offset)."""
    n_img, h, w, c = q.shape
    k, cout = int(wq.shape[0]), int(wq.shape[3])
    b_flat = i8._packed(wq).reshape(-1).to(torch.int64)
    m, kk = torch.arange(TILE_W), torch.arange(32)
    nn = torch.arange(cout)
    out = torch.zeros(n_img, h, w, cout, dtype=torch.int64)
    for n in range(n_img):
        for y0 in range(0, h, TILE_H):
            for x0 in range(0, w, TILE_W):
                smem = _window(q.to(torch.int64), n, y0, x0, k)
                for row in range(TILE_H):
                    d = torch.zeros(TILE_W, cout, dtype=torch.int64)
                    for s in range(k * k * (c // 32)):
                        tap, chunk = divmod(s, c // 32)
                        ky, kx = divmod(tap, k)
                        # A: start, then pixel m at +16 m (core matrices of 8
                        # rows x 16 bytes, 8-row groups 128 bytes apart), the
                        # second K half one plane (lbo = PLANE) further
                        start = 2 * chunk * PLANE + ((row + ky) * WIN_W + kx) * 16
                        a = smem[start + m[:, None] * 16 + (kk // 16) * PLANE + kk % 16]
                        # B: tile s, K half at lbo = cout * 16, channel at 16 n
                        b = b_flat[s * cout * 32 + (kk[:, None] // 16) * cout * 16 + nn * 16 + kk[:, None] % 16]
                        d += a @ b
                    y = y0 + row
                    if y < h:
                        cols = min(TILE_W, w - x0)
                        out[n, y, x0:x0 + cols] = d[:cols]
    return out


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("c,hw", [(32, (5, 70)), (32, (6, 57)), (64, (3, 66)), (64, (7, 13)), (64, (9, 57))])
def test_implicit_gemm_equals_conv_s32(k, c, hw):
    rng = np.random.default_rng(k * 100 + c + hw[1])
    q = torch.from_numpy(rng.integers(-127, 128, (1, *hw, c), dtype=np.int8))
    wq = _weights(k, c, c, c + hw[0])
    got = _implicit_gemm(q, wq)
    want = i8._conv_s32(q.to(torch.float32), wq)
    assert torch.equal(got.to(torch.float32), want)
