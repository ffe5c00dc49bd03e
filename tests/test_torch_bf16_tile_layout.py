"""The bf16 tile of the block and chain kernels, modelled in torch on the CPU.

``csrc/conv_bf16.cuh`` runs every conv of the bf16 K1/K2 and K6/K7 as an
implicit GEMM on ``wgmma.m64n128k16.f32.bf16.bf16`` in persistent,
warp-specialised thread blocks.  These tests read the tile's constants from
the header and replay its address arithmetic in torch: the TMA boxes of each
item's window (out-of-image zeros, no swizzle), the ring slots of half a tap
and the descriptors that read them, the work items of a persistent grid,
the consumers' release of every ring slot, the descriptors' address field,
the fragment of the sums and the staged bf16 tile.  They hold the per-tap sums, added in tap order, equal to
``bf16.conv_exact``'s bit for bit.  The kernels themselves run only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``,
``scripts/probe_bf16_parts.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from image_enhance_keras_tpu_torch.ops.cuda import bf16

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "image_enhance_keras_tpu_torch", "csrc", "conv_bf16.cuh")
with open(HEADER) as _f:
    SRC = _f.read()


def _constants() -> dict:
    """The header's integer constants, in order, each evaluated over the ones before it."""
    out = {}
    for decl in re.findall(r"constexpr (?:int|uint32_t) (\w+ = [^;]+);", SRC):
        for part in decl.split(","):
            name, expr = (v.strip() for v in part.split("=", 1))
            expr = re.sub(r"(?<=\d)u\b", "", expr).replace("/", "//")
            try:
                out[name] = int(eval(expr, {}, dict(out)))
            except (NameError, SyntaxError):
                continue  # a constant over the templates (WIN_BYTES and after): derived below
    return out


K_ = _constants()
C, CONSUMERS, THREADS = K_["C"], K_["CONSUMERS"], K_["THREADS"]
TILE_H, TILE_W, KMAX, PLANES, ACC = K_["TILE_H"], K_["TILE_W"], K_["KMAX"], K_["PLANES"], K_["ACC"]
KTILE, SLOT_K16, SLOT_BYTES, HALVES = K_["KTILE"], K_["SLOT_K16"], K_["SLOT_BYTES"], K_["HALVES"]
STAGES, WINDOWS, STAGE_PITCH = K_["STAGES"], K_["WINDOWS"], K_["STAGE_PITCH"]
PRODUCER_REGS, CONSUMER_REGS = K_["PRODUCER_REGS"], K_["CONSUMER_REGS"]


def win_h(k):
    return TILE_H + k - 1


def win_w(k):
    return TILE_W + k - 1


def box_bytes(k):
    return win_h(k) * win_w(k) * 16


def plane_bytes(k):
    return (box_bytes(k) + 127) // 128 * 128


WIN_BYTES = PLANES * plane_bytes(KMAX)
RING_OFF = WINDOWS * WIN_BYTES
BAR_OFF = RING_OFF + STAGES * SLOT_BYTES
SMEM_BYTES = BAR_OFF + (2 * STAGES + 2 * WINDOWS) * 8


def test_shared_memory_and_register_plan():
    """Two 5x5 windows, the ring and the mbarriers fit a block's 227 KB; a
    staged bf16 tile of both consumers fits a 3x3 window's room; the
    producer's and consumers' setmaxnreg budgets use the 168 registers a
    thread of a 384-thread block has, no more."""
    assert (C, CONSUMERS, THREADS, TILE_H, TILE_W, KMAX) == (128, 2, 384, 8, 16, 5)
    assert SLOT_BYTES == SLOT_K16 * KTILE == 16 * 1024 and HALVES * SLOT_K16 == C // 16
    assert SMEM_BYTES <= 232448 and SMEM_BYTES == 221312
    assert CONSUMERS * 64 * STAGE_PITCH <= PLANES * plane_bytes(3)
    assert all(v % 128 == 0 for v in (WIN_BYTES, RING_OFF, SLOT_BYTES, plane_bytes(3), plane_bytes(5)))
    assert PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS == (65536 // THREADS // 8 * 8) * THREADS
    # three sets of 64 float32 sums (acc and two parts) fit a consumer's registers
    assert 3 * ACC < CONSUMER_REGS


def _tma_box(x, c0, gx0, gy0, n, k):
    """One box (8, win_w, win_h, 1) of the 4-D tensor map over NHWC x at
    (c0, gx0, gy0, n), as TMA lands it: [row][col][8 channels], zeros
    outside the tensor."""
    _, h, w, _ = x.shape
    out = torch.zeros(win_h(k), win_w(k), 8, dtype=x.dtype)
    for r in range(win_h(k)):
        for col in range(win_w(k)):
            y, xx = gy0 + r, gx0 + col
            if 0 <= y < h and 0 <= xx < w:
                out[r, col] = x[n, y, xx, c0:c0 + 8]
    return out


def _window(x, n, y0, x0, k):
    """A window buffer as push_window fills it: plane g at g * plane_bytes(k),
    the box at (8g, x0 - k/2, y0 - k/2, n); one bf16 value a 2 bytes (held
    as float64)."""
    smem = torch.zeros(WIN_BYTES // 2, dtype=torch.float64)
    for g in range(PLANES):
        box = _tma_box(x, 8 * g, x0 - k // 2, y0 - k // 2, n, k).reshape(-1)
        base = g * plane_bytes(k) // 2
        smem[base:base + box.numel()] = box
    return smem


def _image(shape, seed, ints=False):
    rng = np.random.default_rng(seed)
    v = rng.integers(-8, 9, size=(*shape, C)) if ints else rng.normal(size=(*shape, C))
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).double()


@pytest.mark.parametrize("k,hw,tile", [(3, (37, 53), (0, 0)), (5, (37, 53), (32, 48)), (5, (5, 7), (0, 0)),
                                       (3, (9, 35), (8, 32))],
                         ids=["3-corner", "5-last", "5-small", "3-ragged"])
def test_window_boxes_read_the_halo_and_zeros(k, hw, tile):
    """Every window position a tap's descriptor can reach holds x at (y0 - k/2
    + row, x0 - k/2 + col), channel 8g + e, or zero outside the image: SAME
    padding from TMA's out-of-bounds fill."""
    assert "tma_load_4d(win + g * plane_bytes<K>(), map, 8 * g, t.x0 - K / 2, t.y0 - K / 2, t.n, wfull_bar(buf))" in SRC
    x = _image((1, *hw), k)
    y0, x0 = tile
    smem = _window(x, 0, y0, x0, k)
    p = k // 2
    padded = torch.nn.functional.pad(x, (0, 0, p + TILE_W, p + TILE_W, p + TILE_H, p + TILE_H))
    want = padded[0, y0 + TILE_H:y0 + TILE_H + win_h(k), x0 + TILE_W:x0 + TILE_W + win_w(k)]
    r, col, g, e = torch.meshgrid(torch.arange(win_h(k)), torch.arange(win_w(k)), torch.arange(PLANES),
                                  torch.arange(8), indexing="ij")
    addr = g * plane_bytes(k) + (r * win_w(k) + col) * 16 + e * 2
    assert torch.equal(smem[addr // 2], want[r, col, 8 * g + e])
    outside = (y0 - p + r >= hw[0]) | (x0 - p + col >= hw[1]) | (y0 - p + r < 0) | (x0 - p + col < 0)
    assert torch.all(smem[(addr // 2)[outside]] == 0)


def _producer_slots(k, g0=0):
    """push_weights of one KxK conv from ring position g0: per slot number g,
    (slot, tap, half, byte offset in the packed weights)."""
    out = []
    g = g0
    for t in range(k * k):
        for h in range(HALVES):
            out.append((g % STAGES, t, h, (t * HALVES + h) * SLOT_BYTES))
            g += 1
    return out


@pytest.mark.parametrize("k,g0", [(3, 0), (3, 5), (5, 0), (5, 5)], ids=["3", "3-from-5", "5", "5-from-5"])
def test_ring_slots_hold_half_taps_as_the_descriptors_read_them(k, g0):
    """Slot number g holds half h of tap t: 16 KB from byte (2t + h) * 16 KB
    of bf16.packed's layout, whatever ring position the conv starts from;
    the B descriptor of k16 step kk in that slot reads w[ky, kx, 16 (4h + kk)
    + kq, n] at kk * KTILE + (n // 8) * 128 + (n % 8) * 16 + (kq // 8) * C*16 +
    (kq % 8) * 2."""
    assert "bulk_copy(slot_at(slot), src + (size_t)(t * HALVES + h) * SLOT_BYTES, SLOT_BYTES, full_bar(slot));" in SRC
    assert "b_hi | desc_addr(b + kk * KTILE)" in SRC and "b_hi = desc_hi(C * 16, 128)" in SRC
    rng = np.random.default_rng(k * 10 + g0)
    w = torch.from_numpy((rng.normal(size=(k, k, C, C)) * 0.05).astype(np.float32))
    flat = bf16.packed(w).reshape(-1).double()
    want = w.to(torch.bfloat16).double()
    kq, nn = torch.meshgrid(torch.arange(16), torch.arange(C), indexing="ij")
    slots = _producer_slots(k, g0)
    issued = []
    for slot, t, h, off in slots:
        issued.append((t, h))
        ring = flat[off // 2:(off + SLOT_BYTES) // 2]  # what lands in the slot
        ky, kx = divmod(t, k)
        for kk in range(SLOT_K16):
            b = kk * KTILE + (nn // 8) * 128 + (nn % 8) * 16 + (kq // 8) * C * 16 + (kq % 8) * 2
            assert torch.equal(ring[b // 2], want[ky, kx, 16 * (SLOT_K16 * h + kk) + kq, nn])
    # every half tap is issued once, in order, into the ring's next slot
    assert issued == [(t, h) for t in range(k * k) for h in range(HALVES)]
    assert [s[0] for s in slots] == [(g0 + i) % STAGES for i in range(len(slots))]


def _tiles(n, h, w):
    tw = -(-w // TILE_W)
    per = -(-h // TILE_H) * tw
    return [(i // per, (i % per) // tw * TILE_H, (i % per) % tw * TILE_W) for i in range(n * per)]


def _work(tiles, kinds, blocks):
    """Each block's sequence of (kind, tile), as the kernels walk their items:
    block b takes items b, b + blocks, ...; item q is tile q % tiles of conv
    kind q // tiles."""
    return {b: [(q // tiles, q % tiles) for q in range(b, tiles * kinds, blocks)] for b in range(blocks)}


@pytest.mark.parametrize("shape", [(1, 37, 53), (2, 37, 53), (1, 8, 16), (1, 5, 70), (2, 9, 35)])
def test_work_items_cover_every_pixel_once(shape):
    """Whatever the number of blocks (fewer or more than the items): the
    items of each kind cover every output pixel of every image exactly once,
    ragged images and odd numbers of tiles included, and Light53's 5x5 items
    all come before its 3x3 ones in every block."""
    assert "const bool b5 = kLight53 && q < tiles;\n  const Tile t = make_tile(q % tiles, H, W);" in SRC
    n, h, w = shape
    tiles = _tiles(n, h, w)
    assert len(tiles) == n * -(-h // TILE_H) * -(-w // TILE_W)
    for kinds in (1, 2):
        for blocks in (1, 3, 66, 132):
            seqs = _work(len(tiles), kinds, blocks)
            for seq in seqs.values():
                kinds_of = [kd for kd, _ in seq]
                assert kinds_of == sorted(kinds_of)
            for kind in range(kinds):
                cover = torch.zeros(n, h, w, dtype=torch.int64)
                for seq in seqs.values():
                    for kd, tile in seq:
                        if kd == kind:
                            i, y0, x0 = tiles[tile]
                            cover[i, y0:y0 + TILE_H, x0:x0 + TILE_W] += 1
                assert torch.all(cover == 1), (kinds, blocks, kind)


def _consumer_releases(k, g0):
    """conv's ring releases over one KxK conv from ring position g0, against
    the groups' completion under wgmma.wait_group: the slot numbers released,
    in order; a release before its group has finished fails."""
    issued, done, out = [], -1, []

    def wait(n):
        nonlocal done
        done = max(done, len(issued) - 1 - n)

    def release(grp):
        assert grp <= done, "a slot released before its products finished"
        out.append(g0 + grp)

    for t in range(k * k):
        issued += [2 * t, 2 * t + 1]
        wait(1)
        release(2 * t)
        wait(0)
        release(2 * t + 1)
    return out


@pytest.mark.parametrize("k,g0", [(3, 0), (5, 0), (3, 5)], ids=["3", "5", "3-from-5"])
def test_every_slot_released_once_after_its_products(k, g0):
    """Each slot goes back once, after the group that read it has finished,
    in the order the producer filled them: both halves of a tap, tap by tap."""
    assert ("    wgmma_wait<1>();\n    release_slot(g % STAGES);\n    wgmma_wait<0>();\n"
            "    release_slot((g + 1) % STAGES);") in SRC
    got = _consumer_releases(k, g0)
    assert got == list(range(g0, g0 + 2 * k * k))
    assert [g % STAGES for g in got] == [s[0] for s in _producer_slots(k, g0)]


def _sums_by_the_tile(x, w, k):
    """SAME conv by the tile: per item and consumer, per tap the two groups of
    4 k16 steps read through the descriptors (A from the TMA window, B from
    the ring slots), their exact product summed into a fresh float32 part, and
    acc = acc + part in float32, the taps in (ky, kx) order (conv's
    arithmetic)."""
    assert "2 * SLOT_K16 * h * PLANE" in SRC and "a_hi | desc_addr(a + 2 * kk * PLANE)" in SRC
    n_img, h, wd, _ = x.shape
    flat = bf16.packed(w).reshape(-1).double()
    plane, pitch = plane_bytes(k), win_w(k) * 16
    m, kq, nn = torch.arange(64), torch.arange(16), torch.arange(C)
    out = torch.zeros(n_img, h, wd, C, dtype=torch.float32)
    for n, y0, x0 in _tiles(n_img, h, wd):
        smem = _window(x, n, y0, x0, k)
        for cw in range(CONSUMERS):
            wa = cw * 8 * 16
            acc = torch.zeros(64, C, dtype=torch.float32)
            for t in range(k * k):
                ky, kx = divmod(t, k)
                a_cols, b_rows = [], []
                for _, tt, hh, off in _producer_slots(k):
                    if tt != t:
                        continue
                    ring = flat[off // 2:(off + SLOT_BYTES) // 2]
                    a = wa + (ky * win_w(k) + kx) * 16 + 2 * SLOT_K16 * hh * plane
                    for kk in range(SLOT_K16):
                        start = a + 2 * kk * plane
                        addr = start + (m[:, None] // 8) * pitch + (m[:, None] % 8) * 16 + (kq // 8) * plane + \
                            (kq % 8) * 2
                        a_cols.append(smem[addr // 2])
                        b = kk * KTILE + (nn // 8) * 128 + (nn % 8) * 16 + (kq[:, None] // 8) * C * 16 + \
                            (kq[:, None] % 8) * 2
                        b_rows.append(ring[b // 2])
                part = (torch.cat(a_cols, dim=1) @ torch.cat(b_rows, dim=0)).float()
                acc = acc + part
            for mm in range(64):
                y, xx = y0 + mm // 8, x0 + 8 * cw + mm % 8
                if y < h and xx < wd:
                    out[n, y, xx] = acc[mm]
    return out


@pytest.mark.parametrize("k,shape", [(3, (1, 9, 35)), (5, (1, 9, 35)), (5, (2, 5, 7))])
def test_per_tap_sums_equal_conv_exact_bit_for_bit(k, shape):
    """Integer activations and weights of a power of two a tap make every
    tap's sum exact, so that only the float32 adds of the taps round: the
    tile's sums, read through its windows, slots and descriptors, equal
    ``bf16.conv_exact``'s (one product over the channels per tap, the taps
    added in order) bit for bit; a wrong address or another tap order shows."""
    x = _image(shape, 3 * k, ints=True).to(torch.bfloat16)
    rng = np.random.default_rng(k)
    scale = 2.0 ** (-3 * np.arange(k * k, dtype=np.float64)).reshape(k, k, 1, 1)
    w = torch.from_numpy((rng.integers(-8, 9, size=(k, k, C, C)) * scale).astype(np.float32))
    got = _sums_by_the_tile(x.double(), w, k)
    want = bf16.conv_exact(x, w)
    assert torch.equal(got, want)
    # a tile that added the taps in reverse order would differ
    rev = torch.zeros_like(want)
    xs = torch.nn.functional.pad(x.float(), (0, 0, k // 2, k // 2, k // 2, k // 2))
    wb = w.to(torch.bfloat16).float()
    for t in reversed(range(k * k)):
        dy, dx = divmod(t, k)
        rev = rev + xs[:, dy:dy + shape[1], dx:dx + shape[2], :] @ wb[dy, dx]
    assert not torch.equal(rev, want)


def test_fragment_stage_and_copy_out_cover_the_tile():
    """A consumer thread's d[4 n8 + 2 h + e] is pixel (2 warp + h, lane / 4)
    of its 8 x 8 M tile, channel 8 n8 + 2 (lane % 4) + e (the wgmma
    fragment); its bf16 pairs land at p * STAGE_PITCH + 16 n8 + 4 (lane % 4)
    of the staged tile, each 32-bit word once, without a bank conflict in
    any warp's store; the copy-out's 16-byte pieces read every staged word
    once."""
    assert "st + p * STAGE_PITCH + 16 * n8 + 4 * (lane & 3)" in SRC
    seen = torch.zeros(64, C, dtype=torch.int64)
    words = torch.zeros(64 * STAGE_PITCH // 4, dtype=torch.int64)
    for warp in range(4):
        for n8 in range(C // 8):
            for h in range(2):
                banks = []
                for lane in range(32):
                    t = 32 * warp + lane
                    for e in range(2):
                        i = 4 * n8 + 2 * h + e
                        row = 16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2)
                        col = 8 * (i // 4) + 2 * (t % 4) + i % 2
                        assert (row // 8, row % 8) == (2 * warp + h, lane // 4)
                        assert col == 8 * n8 + 2 * (lane % 4) + e
                        seen[row, col] += 1
                    p = (2 * warp + h) * 8 + lane // 4
                    word = (p * STAGE_PITCH + 16 * n8 + 4 * (lane % 4)) // 4
                    assert word * 4 == p * STAGE_PITCH + (8 * n8 + 2 * (lane % 4)) * 2
                    words[word] += 1
                    banks.append(word % 32)
                assert len(set(banks)) == 32
    assert torch.all(seen == 1)
    read = torch.zeros_like(words)
    for i in range(64 * 16):
        p, q = i >> 4, i & 15
        read[(p * STAGE_PITCH + 16 * q) // 4:(p * STAGE_PITCH + 16 * q) // 4 + 4] += 1
    assert torch.equal(read, words)


@pytest.mark.parametrize("base", [0x0, 0x400], ids=["base0", "base0x400"])
def test_descriptor_address_field(base):
    """The descriptors' 14-bit start-address field takes bits 4-17 of the
    shared address: every 16-byte offset of the block's dynamic shared
    memory, from where it starts, fits the field whole (nothing is cut off)
    and never spills into the leading-byte-offset field."""
    assert "return (addr & 0x3FFFF) >> 4;" in SRC

    def desc_addr(addr):
        return (addr & 0x3FFFF) >> 4

    offsets = torch.arange(0, SMEM_BYTES, 16)
    got = torch.tensor([desc_addr(base + int(o)) for o in offsets])
    assert torch.equal(got, (base + offsets) >> 4)
    assert int(got.max()) < 2 ** 14
