"""X1u's launches on ``csrc/int8_conv.cu``, their arithmetic replayed in numpy on the CPU.

X1u (``IEK_INT8_UPQ``'s first HR Light53 block) runs two launches of
``xla_block_kernel``: PAIR_CODES_I8, X1's codes launch over a window of the
int8 codes of the bf16 x f of the LR map (K3q's output), staged by cp.async
with zero fill and nothing quantized; and PAIR_LIGHT53_UP, X1's light53
launch on 4 x 64 tiles whose combine forms the float32 skip, the x f of
0.9 * h_lr, from the LR map itself (``UpSpots``, ``xla_combine_up``,
``prefetch_lr``).  These tests mirror that arithmetic with the kernel's
constants (tests/test_torch_int8_x1_layout.py models the plan, tilings and
taps of both launches) and hold it to what the kernel needs:

* the window staging: 16 bytes of codes a (position, plane of 16 channels)
  at ``g * plane + pos * 16``, zero outside the image, read back through
  the wgmma descriptors' rows, equals the conv inputs;
* the skip: a consumer thread's two HR rows in one LR row pair, the
  neighbour columns, the phase weights of K3's float32 table, the clamped
  last LR row and column, every word read inside the LR map and inside the
  rows and columns its tile prefetches, and the float32 values, step by
  rounded step, bit-equal to ``int8_xla.upq_skip_plain`` at every stored
  output, each stored once.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from image_enhance_keras_tpu_torch.ops.cuda import int8_xla, upsample
from tests.test_torch_int8_x1_layout import MT, TILE_M, TILE_ROWS, TILE_W, _out_pixel, _plan, _tap_positions, _tile, \
    _window_pixel

C, WORDS, STAGERS = 128, 64, 96
F32 = np.float32
#: (n, LR h, LR w, factor): a stripe whose last LR row and column clamp and whose
#: LR width (70) is no multiple of 16, one LR row a tile at f = 4; f = 2, whose
#: HR map leaves part of its last tile unstored; a map narrower than a tile
SKIP_SHAPES = [(1, 5, 70, 4), (2, 3, 9, 2), (1, 2, 5, 4)]


def _lr_map(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(n, h, w, C)) * 2).astype(F32)).to(torch.bfloat16)


def _up_spots(t, lr_h, lr_w, f, wt):
    """UpSpots::at for the 256 consumer threads of tile t (arrays over threads)."""
    tid = np.arange(128, 384)
    cw, warp, lane = tid // 128 - 1, (tid & 127) >> 5, tid & 31
    r0 = warp * 16 + lane // 4
    n, y0, x0 = t
    y = y0 + MT * cw
    kk = y // f
    k = np.minimum(kk, lr_h - 1)
    r = y[:, None] + np.arange(MT)[None, :] - (kk * f)[:, None]  # (threads, MT)
    x = x0 + r0[:, None] + 8 * np.arange(2)[None, :]  # (threads, 2)
    mm = x // f
    m = np.minimum(mm, lr_w - 1)
    s = x - mm * f
    return dict(cw=cw, lane=lane, r0=r0, y=y, kk=kk, k=k, row=((n * lr_h + k) * lr_w) * WORDS,
                dk=(np.minimum(k + 1, lr_h - 1) - k) * lr_w * WORDS, r=r, wr0=wt[r], wr1=wt[f + r],
                m=m, s=s, col=m * WORDS, dm=(np.minimum(m + 1, lr_w - 1) - m) * WORDS, ws0=wt[s], ws1=wt[f + s])


def _lerp(a, w0, b, w1):
    """K3's float32 lerp: each product and the sum rounded on its own (numpy float32 does not fuse)."""
    return (a * w0).astype(F32) + (b * w1).astype(F32)


@pytest.mark.parametrize("shape", SKIP_SHAPES)
def test_skip_from_the_lr_map_equals_upq_skip_plain(shape):
    """For every tile of the light53 launch (4 x 64 tiles, as geometry keeps
    it for this launch), every consumer thread, column block and channel
    group: the LR words UpSpots and load() address, y = h * 0.9, the H pass
    at columns m and m1 with the weights of r, then the W pass with those of
    s, as xla_combine_up rounds them, equal upq_skip_plain at the stored
    outputs, each stored once; the thread's two rows share the LR row pair,
    and every word read lies in the map and in its tile's prefetched rows
    and columns."""
    n, lr_h, lr_w, f = shape
    hr_h, hr_w = f * lr_h, f * lr_w
    h_lr = _lr_map(n, lr_h, lr_w, sum(shape))
    want = int8_xla.upq_skip_plain(h_lr, f).numpy()
    lr = h_lr.float().numpy().reshape(-1)  # word w holds channels 2 w, 2 w + 1
    wt = np.asarray(upsample.weight_table(f, torch.float32)[0] + upsample.weight_table(f, torch.float32)[1], F32)
    p = _plan(n, hr_h, hr_w, "light53_up")
    assert not p["raster"]
    count = np.zeros((n, hr_h, hr_w, C), np.int64)
    for tile in range(p["tiles"]):
        t = _tile(p, tile)
        u = _up_spots(t, lr_h, lr_w, f, wt)
        assert ((u["y"][:, None] + np.arange(MT)) // f == u["kk"][:, None]).all()  # one LR row pair a thread
        assert ((u["r"] >= 0) & (u["r"] < f)).all() and ((u["s"] >= 0) & (u["s"] < f)).all()
        # prefetch_lr's rows and columns
        k_lo, k_hi = min(t[1] // f, lr_h - 1), min((t[1] + TILE_ROWS - 1) // f + 1, lr_h - 1)
        m_lo, m_hi = min(t[2] // f, lr_w - 1), min((t[2] + TILE_W - 1) // f + 1, lr_w - 1)
        q = u["lane"] & 3
        for nb in range(C // 64):
            for n8 in range(8):
                words = np.empty((256, 2, 4), np.int64)  # load(): (k, m), (k1, m), (k, m1), (k1, m1) of each h
                base = u["row"] + nb * 32 + 4 * n8 + q
                for h in range(2):
                    a = base + u["col"][:, h]
                    words[:, h] = np.stack([a, a + u["dk"], a + u["dm"][:, h], a + u["dk"] + u["dm"][:, h]], 1)
                assert words.min() >= 0 and words.max() < n * lr_h * lr_w * WORDS
                pix = words // WORDS
                kr, mc = (pix // lr_w) % lr_h, pix % lr_w
                assert ((kr >= k_lo) & (kr <= k_hi) & (mc >= m_lo) & (mc <= m_hi)).all()
                for ch in range(2):
                    y = (lr[2 * words + ch] * F32(0.9)).astype(F32)  # (threads, h, neighbour)
                    for j in range(MT):
                        for h in range(2):
                            hm = _lerp(y[:, h, 0], u["wr0"][:, j], y[:, h, 1], u["wr1"][:, j])
                            hm1 = _lerp(y[:, h, 2], u["wr0"][:, j], y[:, h, 3], u["wr1"][:, j])
                            skip = _lerp(hm, u["ws0"][:, h], hm1, u["ws1"][:, h])
                            mpos = torch.from_numpy((u["cw"] * MT + j) * TILE_W + u["r0"] + 8 * h)
                            oy, ox, st = (v.numpy() for v in _out_pixel(p, t, mpos))
                            co = nb * 64 + 2 * q + 8 * n8 + ch
                            np.testing.assert_array_equal(skip[st], want[t[0], oy[st], ox[st], co[st]])
                            count[t[0], oy[st], ox[st], co[st]] += 1
    assert (count == 1).all()


def _staged_window(q, p, t, e, positions):
    """stage_window<int8_t>: item i = (pos, g) of the STAGERS threads' stride
    copies 16 bytes of the codes of pixel (gy, gx), channels 16 g.., to
    g * plane + pos * 16 of the window (zero fill outside the image)."""
    planes = q.shape[-1] // 16
    plane = positions * 16 + 16
    win = np.full(planes * plane, 77, np.int8)  # bytes no item writes keep a mark
    items = positions * planes
    for tid in range(STAGERS):
        i = np.arange(tid, items, STAGERS)
        pos, g = i // planes, i % planes
        gy, gx, inside = (v.numpy() for v in _window_pixel(p, t, e, torch.from_numpy(pos)))
        src = np.zeros((len(i), 16), np.int8)
        src[inside] = q[t[0], gy[inside], gx[inside]].reshape(-1, planes, 16)[np.arange(int(inside.sum())), g[inside]]
        win[(g * plane + pos * 16)[:, None] + np.arange(16)] = src
    return win, plane


@pytest.mark.parametrize("kw", [3, 5])
@pytest.mark.parametrize("hw", [(20, 280), (8, 36)])
def test_codes_window_rows_are_the_conv_inputs(kw, hw):
    """X1u's codes launch (PAIR_CODES_I8, halo 2, both first convs over one
    window): the bytes the wgmma descriptors read for M tile row m, tap
    (ky, kx) and K step k (16 channels at the tap's position in plane 2 k,
    16 more a plane on) are the codes of the conv input (y + ky - K, x +
    kx - K), zero outside the image, in the 4 x 64 and the raster tiling."""
    h, w = hw
    rng = np.random.default_rng(h * w + kw)
    q = rng.integers(-127, 128, (1, h, w, C), dtype=np.int8)
    p = _plan(1, h, w, "codes_i8")
    m = torch.arange(TILE_M)
    k = kw // 2
    for tile in range(p["tiles"]):
        t = _tile(p, tile)
        win, plane = _staged_window(q, p, t, 2, p["positions"])
        y, x, st = (v.numpy() for v in _out_pixel(p, t, m))
        ky, kx, pos = (v.numpy() for v in _tap_positions(p, m, kw, 2))
        for step in range(C // 32):
            lo = win[(2 * step * plane + pos * 16)[..., None] + np.arange(16)]
            hi = win[((2 * step + 1) * plane + pos * 16)[..., None] + np.arange(16)]
            got = np.concatenate([lo, hi], -1)[:, st]  # (taps, stored, 32)
            gy, gx = (y[None, :] + ky - k)[:, st], (x[None, :] + kx - k)[:, st]
            inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
            want = np.zeros_like(got)
            want[inside] = q[0, gy[inside], gx[inside], 32 * step:32 * step + 32]
            np.testing.assert_array_equal(got, want)
