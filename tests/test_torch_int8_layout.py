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


# -- the dynamic ring launch: M tiles in raster order over a ring segment --------
#: the kernel's widest staged pitch (PITCH_MAX) and positions a thread block holds
PITCH_MAX, BLOCK_POS = 136, TILE_H * TILE_W


def _ring_grid(eh, ew, kw):
    """csrc/int8_blocks.cu ring_grid: (sw, pitch, nb, nseg) of an eh x ew ring."""
    maxw = PITCH_MAX - (kw - 1)
    nseg = -(-ew // maxw)
    sw = -(-ew // nseg)
    pitch = sw + kw - 1
    nb = -(-((eh - 1) * pitch + sw) // BLOCK_POS)
    return sw, pitch, nb, nseg


def _raster_gemm(xin, wq, eh, ew, kw):
    """The ring launch's conv of the staged input ``xin`` ((eh + kw - 1, ew +
    kw - 1, C) codes: the ring's window with its halo) by the kernel's
    arithmetic: per segment and block, TILE_PIX + (kw-1) * (pitch+1) pixels
    staged from input raster position p0 on (planes of 16 channels), and per
    M tile, tap and 32-channel step the A start moved by ky * pitch + kx
    pixels (+ the halo beyond this conv's, D); the sums land at raster
    positions p0 + 64 mt + m, kept where they fall in the segment and the
    ring (not in the pitch's other columns)."""
    c = int(xin.shape[-1])
    k, cout = int(wq.shape[0]), int(wq.shape[3])
    d_off = (kw - k) // 2
    sw, pitch, nb, nseg = _ring_grid(eh, ew, kw)
    assert pitch <= PITCH_MAX
    plane = (BLOCK_POS + (KMAX - 1) * (PITCH_MAX + 1)) * 16 + 16
    sp = BLOCK_POS + (kw - 1) * (pitch + 1)
    b_flat = i8._packed(wq).reshape(-1).to(torch.int64)
    m, kk, nn = torch.arange(TILE_W), torch.arange(32), torch.arange(cout)
    x64 = xin.to(torch.int64)
    out = torch.full((eh, ew, cout), -(1 << 40), dtype=torch.int64)
    for seg in range(nseg):
        cs = seg * sw
        for blk in range(nb):
            p0 = blk * BLOCK_POS
            smem = torch.zeros(c // 16 * plane, dtype=torch.int64)
            for q in range(sp):
                iy, ix = divmod(p0 + q, pitch)
                if iy < xin.shape[0] and cs + ix < xin.shape[1]:
                    for g in range(c // 16):
                        smem[g * plane + q * 16:g * plane + q * 16 + 16] = x64[iy, cs + ix, 16 * g:16 * g + 16]
            for mt in range(TILE_H):
                dacc = torch.zeros(TILE_W, cout, dtype=torch.int64)
                for s in range(k * k * (c // 32)):
                    tap, chunk = divmod(s, c // 32)
                    ky, kx = divmod(tap, k)
                    first = mt * TILE_W + (ky + d_off) * pitch + kx + d_off
                    assert first + TILE_W <= sp  # A reads staged pixels only
                    start = 2 * chunk * plane + first * 16
                    a = smem[start + m[:, None] * 16 + (kk // 16) * plane + kk % 16]
                    b = b_flat[s * cout * 32 + (kk[:, None] // 16) * cout * 16 + nn * 16 + kk[:, None] % 16]
                    dacc += a @ b
                for i in range(TILE_W):
                    ey, lx = divmod(p0 + mt * TILE_W + i, pitch)
                    if lx < sw and ey < eh and cs + lx < ew:
                        assert out[ey, cs + lx, 0] == -(1 << 40)  # each ring position once
                        out[ey, cs + lx] = dacc[i]
    return out


#: (ring height, ring width, conv k, staging halo kw): Light's conv3 (kw 3),
#: Light53's conv3 and conv5 over one staged window (kw 5); ring widths of the
#: LR and HR windows (100 = 96 + 4, 132 = 128 + 4), a ragged one, one wider
#: than a segment (two segments of 70)
RASTER_CASES = [(5, 100, 5, 5), (5, 100, 3, 5), (4, 132, 3, 5), (4, 132, 5, 5), (3, 130, 3, 3),
                (6, 37, 3, 3), (5, 37, 5, 5), (3, 140, 3, 5)]


@pytest.mark.parametrize("eh,ew,k,kw", RASTER_CASES)
def test_raster_m_tiles_equal_valid_conv_s32(eh, ew, k, kw):
    c = 32
    rng = np.random.default_rng(eh * 1000 + ew + 10 * k + kw)
    xin = torch.from_numpy(rng.integers(-127, 128, (eh + kw - 1, ew + kw - 1, c), dtype=np.int8))
    wq = _weights(k, c, c, ew + k)
    got = _raster_gemm(xin, wq, eh, ew, kw)
    d = (kw - k) // 2
    want = i8._conv_valid_s32(xin[None, d:, d:].to(torch.float32), wq, eh, ew)[0]
    assert torch.equal(got.to(torch.float32), want)


@pytest.mark.parametrize("eh,ew,kw", [(52, 100, 5), (68, 132, 5), (50, 98, 3), (10, 204, 5), (8, 60, 3)])
def test_ring_grid_covers_the_ring_within_the_staged_window(eh, ew, kw):
    """Segments and blocks cover every ring position once; the staged pixels
    of every block fit the kernel's plane (PITCH_MAX); at the LR and HR
    windows' rings the products overhang the ring by under 1.1x (4 x 64
    tiles: 1.28x, 1.45x)."""
    sw, pitch, nb, nseg = _ring_grid(eh, ew, kw)
    assert pitch <= PITCH_MAX and sw * nseg >= ew > sw * (nseg - 1)
    covered = torch.zeros(eh, ew, dtype=torch.int64)
    for seg in range(nseg):
        p = torch.arange(nb * BLOCK_POS)
        ey, lx = p // pitch, p % pitch
        ok = (lx < sw) & (ey < eh) & (seg * sw + lx < ew)
        covered.index_put_((ey[ok], seg * sw + lx[ok]), torch.ones(int(ok.sum()), dtype=torch.int64),
                           accumulate=True)
    assert bool((covered == 1).all())
    if ew in (100, 132):
        assert nseg * nb * BLOCK_POS / (eh * ew) < 1.1


# -- the dynamic code without the division -------------------------------------
MAGIC = 12582912.0  # 1.5 * 2^23: adding it rounds a float32 in [-127, 127] half to even


def _codes8_div(v: torch.Tensor, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """csrc/int8_blocks.cu ``codes8_div`` in float32 (FMAs by ``_fma``): q0 = v
    * (1 / s) rounded, clamped to +-127 and rounded half to even; where q0 lies
    within 2^-15 of a half-integer, the quotient rounded by two corrections
    q <- q + (v - q s) (1 / s).  Returns (codes, where the corrections ran)."""
    rs = torch.tensor(1.0, dtype=torch.float32) / s
    q0 = v * rs
    c = q0.clamp(-127.0, 127.0)
    r = c + MAGIC
    near = (c - (r - MAGIC)).abs() >= 0.5 - 2.0**-15
    q1 = i8._fma(i8._fma(-q0, s, v), rs, q0)
    q2 = i8._fma(i8._fma(-q1, s, v), rs, q1)
    exact = q2.clamp(-127.0, 127.0) + MAGIC - MAGIC
    return torch.where(near, exact, r - MAGIC).to(torch.int8), near


@pytest.mark.parametrize("amax", [1e-12, 3e-7, 0.73, 1.0, 6.5, 113.0, 4e5])
def test_codes8_div_equals_the_rounded_quotient(amax):
    """The kernel's division-free codes equal clamp(rint(v / s), +-127) of the
    rounded quotient (the plain versions' _quant_dyn) on random values and on
    values within a few ulps of every half-integer step, where the product
    with 1 / s alone rounds the other way for some; the corrections run for
    a small share of random values."""
    f = np.float32
    s = torch.tensor(max(f(amax), f(1e-12)) * f(1.0 / 127.0))
    rng = np.random.default_rng(int(amax * 1000) % 997)
    rand = (rng.uniform(-1.0, 1.0, 200_000) * amax).astype(f)
    ties = ((np.arange(-127, 128, dtype=np.float64) + 0.5) * np.float64(s)).astype(f)
    edge, up, down = [ties], ties, ties
    for _ in range(3):
        up, down = np.nextafter(up, f(np.inf)), np.nextafter(down, f(-np.inf))
        edge += [up, down]
    halves = np.array([amax, -amax], f) / f(2)  # half the abs-max: 63.5 up to rounding
    extra = np.array([0.0, -0.0, amax, -amax, 3e38, -3e38, np.inf, -np.inf], f)
    v = torch.from_numpy(np.concatenate(edge + [rand, ties * f(1.5), halves, extra]))
    want = torch.clamp(torch.round(v / s), -127.0, 127.0).to(torch.int8)
    got, near = _codes8_div(v, s)
    assert torch.equal(got, want)
    n_edge = 7 * ties.size
    assert near[n_edge:n_edge + rand.size].float().mean() < 1e-3
    product_only = torch.clamp(torch.round(v * (1.0 / s)), -127.0, 127.0).to(torch.int8)
    assert not torch.equal(product_only, want)
