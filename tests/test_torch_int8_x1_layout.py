"""X1's and X2's persistent launches on ``csrc/int8_conv.cu``, their host-side plan replayed in torch on the CPU.

X1 (the ``--forward int8`` static Light53 block) runs as two launches of
``xla_block_kernel``: the codes launch stages one window of bf16 x with
the 5 x 5 halo and runs both first convs over it; the light53 launch stages
ta's window (halo 2) and tb's (halo 1) and runs both second convs per 64
output channels.  X2 (the Light block) runs one 3 x 3 conv a launch (halo
1).  Each block walks the tiles ``blockIdx.x, + gridDim.x, ...`` (one block
per SM), and ``geometry()`` picks each launch's tiling: 256 positions of the
raster padded to a pitch of W + 2 E (E the widest conv's halo) where W is
not a multiple of 64 and two windows fit, else 4 x 64 tiles at a pitch of
64 + 2 E.  X4 (the zoo's 3 x 3 conv) shares the plan.  These tests
mirror that plan (same constants) and hold it to what the kernel needs:
every output position stored once, every tap reading its input pixel (zero
outside the image) inside the staged window, the weights at the offsets the
descriptors read, the sums of the implicit GEMM equal to the exact conv.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks, int8_conv

# csrc/int8_conv.cu's constants
TILE_W, MT, CONSUMERS = 64, 2, 2
TILE_M, TILE_ROWS = TILE_W * MT * CONSUMERS, MT * CONSUMERS
MAX_STAGES, X_STAGES, MIN_STAGES, WINDOWS, SMEM_MAX, CIN_MAX = 8, 16, 4, 2, 232448, 256
BAR_BYTES = (8 * (2 * MAX_STAGES + 2 * WINDOWS + 2) + 127) // 128 * 128
X_BAR_BYTES = (8 * (2 * X_STAGES + 2 * WINDOWS + 2) + 127) // 128 * 128
#: K steps a ring slot: X1's second launch (2 KB steps), X1's first and X2's (4 KB steps); X4 one
X_S64, X_S128 = 4, 2
SMS = 132
#: the launches: (E, halo of the second window or -1, NT, vector bytes, mbarrier bytes, ring slots at most):
#: X4 at C_out 128; X1's codes and light53 launches; X2's codes and light launches; X1u's (IEK_INT8_UPQ's
#: first HR block: X1's codes launch over a window of int8 codes, its light53 launch with the skip formed
#: from the LR map, on 4 x 64 tiles only)
XVEC = 7 * 128 * 4  # the reciprocals and dequant vectors of X1 and X2 in shared memory
FORMS = {"x4": (1, -1, 128, (CIN_MAX + 128) * 4, BAR_BYTES, MAX_STAGES),
         "codes": (2, -1, 128, XVEC, X_BAR_BYTES, X_STAGES), "light53": (2, 1, 64, XVEC, X_BAR_BYTES, X_STAGES),
         "one_codes": (1, -1, 128, XVEC, X_BAR_BYTES, X_STAGES), "one_light": (1, -1, 128, XVEC, X_BAR_BYTES, X_STAGES),
         "codes_i8": (2, -1, 128, XVEC, X_BAR_BYTES, X_STAGES), "light53_up": (2, 1, 64, XVEC, X_BAR_BYTES, X_STAGES)}
#: the launches that keep to 4 x 64 tiles (geometry's raster_ok false)
NO_RASTER = ("light53_up",)
#: chip_smoke.py's INT8_RAGGED crops and the LR and HR shapes
SHAPES = [(9, 96, 96), (9, 384, 384), (1, 57, 86), (1, 70, 70), (1, 86, 57), (1, 5, 70), (1, 8, 64)]


def _plan(n, h, w, form, cin=128):
    """geometry() as launch_xla / launch_conv call it: the tiling, windows,
    ring and tiles of one launch; a ring slot holds X_S64 or X_S128 K steps
    in X1's and X2's launches."""
    e_max, halo2, nt, vec_bytes, bar_bytes, max_stages = FORMS[form]
    steps = 1 if form == "x4" else X_S64 if form.startswith("light53") else X_S128
    planes, b_tile = cin // 16, nt * 32 * steps

    def pitch_of(raster):
        return w + 2 * e_max if raster else TILE_W + 2 * e_max

    def positions_of(raster, e):
        p = pitch_of(raster)
        return TILE_M + 2 * e * p + 2 * e_max if raster else (TILE_ROWS + 2 * e) * p

    def bytes_of(positions):
        return planes * (positions * 16 + 16)

    def slots(raster, nwin):
        wins = bar_bytes + nwin * bytes_of(positions_of(raster, e_max))
        wins += bytes_of(positions_of(raster, halo2)) if halo2 >= 0 else 0
        return (SMEM_MAX - (wins + 127) // 128 * 128 - vec_bytes) // b_tile

    raster = form not in NO_RASTER and w % TILE_W != 0 and slots(True, WINDOWS) >= MIN_STAGES
    nwin = WINDOWS if slots(raster, WINDOWS) >= MIN_STAGES else 1
    ring = slots(raster, nwin)
    assert ring >= 2
    p = dict(raster=raster, pitch=pitch_of(raster), nwin=nwin, stages=min(ring, max_stages), E=e_max, n=n, h=h, w=w,
             positions=positions_of(raster, e_max), positions2=positions_of(raster, halo2) if halo2 >= 0 else 0)
    win_end = bar_bytes + nwin * bytes_of(p["positions"]) + (bytes_of(p["positions2"]) if halo2 >= 0 else 0)
    p["smem"] = (win_end + 127) // 128 * 128 + p["stages"] * b_tile + vec_bytes
    if raster:
        p["tiles_w"], per = 1, -(-h * p["pitch"] // TILE_M)
    else:
        p["tiles_w"] = -(-w // TILE_W)
        per = p["tiles_w"] * -(-h // TILE_ROWS)
    p["tiles_a_sample"], p["tiles"] = per, per * n
    return p


def _tile(p, tile):
    """tile_of: (n, y0, x0); the raster tiling's first raster position in y0."""
    n, r = divmod(tile, p["tiles_a_sample"])
    if p["raster"]:
        return n, r * TILE_M, 0
    return n, (r // p["tiles_w"]) * TILE_ROWS, (r % p["tiles_w"]) * TILE_W


def _out_pixel(p, t, m):
    """out_pixel: (y, x, stored) of output positions m of tile t."""
    _, y0, x0 = t
    if p["raster"]:
        rr = y0 + m
        y = rr // p["pitch"]
        x = rr - y * p["pitch"] - p["E"]
    else:
        y, x = y0 + m // TILE_W, x0 + m % TILE_W
    return y, x, (y < p["h"]) & (x >= 0) & (x < p["w"])


def _window_pixel(p, t, e, pos):
    """window_pixel: (gy, gx, inside the image) of positions pos of tile t's window of halo e."""
    _, y0, x0 = t
    pitch, big_e = p["pitch"], p["E"]
    if p["raster"]:
        rr = y0 + pos + pitch - big_e
        gy = rr // pitch - (e + 1)
        gx = rr - (gy + e + 1) * pitch - big_e
    else:
        wr = pos // pitch
        gy, gx = y0 - e + wr, x0 - big_e + pos - wr * pitch
    return gy, gx, (gy >= 0) & (gy < p["h"]) & (gx >= 0) & (gx < p["w"])


def _tap_positions(p, m, kw, e):
    """The window positions output positions m read through tap (ky, kx) of a
    kw x kw conv over a window of halo e: the consumer's M tile start plus the
    descriptor's move (ky - K + e) * pitch + kx - K + E; (taps, len(m))."""
    k = kw // 2
    row = m // TILE_W
    base = row * (TILE_W if p["raster"] else p["pitch"]) + m % TILE_W
    ky, kx = torch.meshgrid(torch.arange(kw), torch.arange(kw), indexing="ij")
    move = (ky - k + e) * p["pitch"] + kx - k + p["E"]
    return ky.reshape(-1, 1), kx.reshape(-1, 1), base[None, :] + move.reshape(-1, 1)


def test_tilings_of_the_main_shapes():
    """The LR map (W = 96) takes raster tiles at a pitch of 100 in X1's codes
    launch (two windows of 660 positions and a ring of 7 slots of two K
    steps) and 4 x 64 tiles in its light53 launch (two of ta's windows and
    tb's on raster tiles would leave no ring): ta's window 8 x 68 positions,
    tb's 6 x 68, 4 slots of four 2 KB K steps; X2's launches take raster
    tiles at a pitch of 98; W = 384 takes 4 x 64 tiles.  Every launch keeps
    two window buffers and a ring of at least 4 slots within 227 KB."""
    lr_codes, lr_l53 = _plan(9, 96, 96, "codes"), _plan(9, 96, 96, "light53")
    assert lr_codes["raster"] and lr_codes["pitch"] == 100 and lr_codes["positions"] == 660
    assert lr_codes["stages"] == 7
    assert not lr_l53["raster"] and lr_l53["pitch"] == 68 and lr_l53["positions"] == 8 * 68
    assert lr_l53["positions2"] == 6 * 68 and lr_l53["stages"] == 4
    for form in ("one_codes", "one_light"):
        p = _plan(9, 96, 96, form)
        assert p["raster"] and p["pitch"] == 98 and p["stages"] >= 8
    for form in ("codes", "light53", "one_codes", "one_light"):
        hr = _plan(9, 384, 384, form)
        assert not hr["raster"] and hr["tiles"] == 9 * 6 * 96
    for n, h, w in SHAPES:
        for form in FORMS:
            p = _plan(n, h, w, form)
            assert p["smem"] <= SMEM_MAX and p["nwin"] == WINDOWS
            assert MIN_STAGES <= p["stages"] <= (MAX_STAGES if form == "x4" else X_STAGES)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("shape", SHAPES)
def test_persistent_walk_covers_every_output_once(form, shape):
    """Each block (min(tiles, 132) of them) walks tiles blockIdx.x, +gridDim.x,
    ...; the stored positions of all tiles cover every (n, y, x) once."""
    n, h, w = shape
    p = _plan(n, h, w, form)
    grid = min(p["tiles"], SMS)
    count = torch.zeros((n, h, w), dtype=torch.int64)
    m = torch.arange(TILE_M)
    walked = 0
    for b in range(grid):
        for tile in range(b, p["tiles"], grid):
            t = _tile(p, tile)
            y, x, st = _out_pixel(p, t, m)
            count.index_put_((torch.full_like(y[st], t[0]), y[st], x[st]), torch.ones(int(st.sum()), dtype=torch.int64),
                             accumulate=True)
            walked += 1
    assert walked == p["tiles"]
    assert torch.equal(count, torch.ones_like(count))


#: (form, conv width kw, window halo e): X4's 3 x 3, X1's codes launch's
#: conv3 and conv5 over one halo-2 window, its light53 launch's conv5 over
#: ta's (halo 2) and conv3 over tb's (halo 1), X2's conv3 (halo 1); X1u's
#: conv5 over its codes window, and its light53 launch's two on 4 x 64 tiles
TAPS = [("x4", 3, 1), ("codes", 3, 2), ("codes", 5, 2), ("light53", 5, 2), ("light53", 3, 1), ("one_codes", 3, 1),
        ("codes_i8", 5, 2), ("light53_up", 5, 2), ("light53_up", 3, 1)]


@pytest.mark.parametrize("form,kw,e", TAPS)
@pytest.mark.parametrize("shape", [(2, 96, 96), (1, 57, 86), (1, 70, 70), (1, 5, 70), (1, 8, 64), (1, 9, 200)])
def test_window_taps_read_the_conv_inputs(form, kw, e, shape):
    """For every tile, output position and tap, the position the descriptor
    reads lies in the staged window (of positions, or positions2 for tb's)
    and holds the conv's input pixel (y + ky - K, x + kx - K), staged as zero
    where that lies outside the image, in both tilings."""
    n, h, w = shape
    p = _plan(n, h, w, form)
    size = p["positions2"] if (form.startswith("light53") and e == 1) else p["positions"]
    k = kw // 2
    m = torch.arange(TILE_M)
    for tile in range(p["tiles"]):
        t = _tile(p, tile)
        y, x, st = _out_pixel(p, t, m)
        ky, kx, pos = _tap_positions(p, m, kw, e)
        assert int(pos.min()) >= 0 and int(pos.max()) < size  # stored or not, reads stay in the window
        gy, gx, inside = _window_pixel(p, t, e, pos)
        want_y, want_x = y[None, :] + ky - k, x[None, :] + kx - k
        want_in = (want_y >= 0) & (want_y < h) & (want_x >= 0) & (want_x < w)
        sel = st[None, :].expand_as(pos)
        assert torch.equal(inside[sel], want_in[sel])
        both = sel & want_in
        assert torch.equal(gy[both], want_y[both]) and torch.equal(gx[both], want_x[both])


def _weights(k, cin, cout, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(-127, 128, (k, k, cin, cout), dtype=np.int8))


@pytest.mark.parametrize("k,nt", [(3, 128), (5, 128), (5, 64), (3, 64)])
def test_packed_tiles_at_the_descriptor_offsets(k, nt):
    """``int8_conv.packed(w, nt)``, X1's weights: tile (tap, 32-channel step,
    column block nb) at ((tap * C/32 + step) * C/NT + nb) * NT * 32 bytes
    (push_conv), the second K half NT * 16 bytes on (the B descriptor's
    leading byte offset), output channel co % NT at 16 (co % NT); every byte once."""
    c = 128
    wq = _weights(k, c, c, k * nt)
    flat = int8_conv.packed(wq, nt).reshape(-1)
    ky, kx, ci, co = torch.meshgrid(torch.arange(k), torch.arange(k), torch.arange(c), torch.arange(c), indexing="ij")
    tile = ((ky * k + kx) * (c // 32) + ci // 32) * (c // nt) + co // nt
    off = tile * nt * 32 + (ci % 32) // 16 * nt * 16 + (co % nt) * 16 + ci % 16
    assert torch.equal(flat[off], wq)
    assert torch.equal(torch.sort(off.reshape(-1)).values, torch.arange(flat.numel()))
    assert int8_conv.packed(wq, nt) is int8_conv.packed(wq, nt)  # cached, one pack per nt
    if nt == 128:  # one column block: the same bytes as the K4/K5 pack
        assert torch.equal(flat, int8_blocks._packed(wq).reshape(-1))


def _pair_sums(q, wq, form, kw, e, nt):
    """One conv of X1's launch as the kernel computes it: per tile the window
    of halo e staged from the codes q (zero outside the image), per column
    block and K step the A rows read at the tap's positions and the B tile of
    ``packed(wq, nt)``; the stored positions' sums, (n, h, w, C_out)."""
    n, h, w, c = (int(s) for s in q.shape)
    cout = int(wq.shape[-1])
    p = _plan(n, h, w, form, cin=c)
    size = p["positions2"] if (form.startswith("light53") and e == 1) else p["positions"]
    b = int8_conv.packed(wq, nt).reshape(-1).to(torch.int64)
    kk, nn = torch.arange(32), torch.arange(nt)
    q64 = q.to(torch.int64)
    out = torch.zeros((n, h, w, cout), dtype=torch.int64)
    m = torch.arange(TILE_M)
    for tile in range(p["tiles"]):
        t = _tile(p, tile)
        gy, gx, inside = _window_pixel(p, t, e, torch.arange(size))
        win = torch.zeros((size, c), dtype=torch.int64)
        win[inside] = q64[t[0], gy[inside], gx[inside]]
        y, x, st = _out_pixel(p, t, m)
        _, _, pos = _tap_positions(p, m, kw, e)
        for nb in range(cout // nt):
            d = torch.zeros((TILE_M, nt), dtype=torch.int64)
            for tap in range(kw * kw):
                for chunk in range(c // 32):
                    a = win[pos[tap]][:, 32 * chunk:32 * chunk + 32]
                    s = ((tap * (c // 32) + chunk) * (cout // nt) + nb) * nt * 32
                    bt = b[s + (kk[:, None] // 16) * nt * 16 + nn * 16 + kk[:, None] % 16]
                    d += a @ bt
            out[t[0], y[st], x[st], nb * nt:(nb + 1) * nt] = d[st]
    return out


@pytest.mark.parametrize("form,kw,e", TAPS[1:])
@pytest.mark.parametrize("hw", [(5, 70), (9, 57), (8, 64)])
def test_implicit_gemm_equals_conv_s32(form, kw, e, hw):
    """The sums of each of X1's convs, by the kernel's arithmetic, equal the
    exact SAME conv of the codes (raster and 4 x 64 tiles, NT 128 and 64)."""
    c = 64
    rng = np.random.default_rng(kw * 10 + e + hw[1])
    q = torch.from_numpy(rng.integers(-127, 128, (1, *hw, c), dtype=np.int8))
    wq = _weights(kw, c, 128, kw + hw[0])
    got = _pair_sums(q, wq, form, kw, e, FORMS[form][2])
    want = int8_blocks._conv_s32(q.to(torch.float32), wq)
    assert torch.equal(got.to(torch.float32), want)
