"""The bf16 kernels' weight pack, modelled in torch on the CPU.

``csrc/conv_bf16.cuh`` runs each conv of the bf16 K1/K2 and K6/K7 as an
implicit GEMM on ``wgmma.m64n128k16.f32.bf16.bf16``: B is the weight tile of
one (tap, 16-input-channel step), read from ``bf16.packed`` at the offsets
of its descriptor.  These tests hold the pack's rounding and its offsets,
and its cache apart from the 3xTF32 packer's; the tile's windows, ring and
sums are modelled in ``tests/test_torch_bf16_tile_layout.py``.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from image_enhance_keras_tpu_torch.ops.cuda import bf16, tf32x3

C = 128
B_TILE = 16 * C * 2               # bytes of a (tap, 16-channel step) weight tile
B_SLOT = 4 * B_TILE               # half a tap's tiles: one slot of the weight ring


def _weights(k, seed, n_blocks=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(n_blocks, k, k, C, C)) * 0.05).astype(np.float32))


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
    """Every weight at the byte offset push_weights and the B descriptor give
    it: block kb, tap, 16-channel step ci // 16 (slot half ci // 64 of the
    tap, step ci // 16 % 4 in it), the K half (ci % 16) // 8 at lbo = C*16,
    output channel co at co*16, input channel ci % 8 at 2 bytes each.  One
    block's (k, k, C, C) weights (K1/K2) pack as the K = 1 slice of the
    stacked chain layout (K6/K7)."""
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
    slot = (tap * 2 + ci // 64) * B_SLOT  # push_weights: (t * HALVES + h) * SLOT_BYTES
    off = slot + (ci // 16 % 4) * B_TILE + (ci % 16) // 8 * C * 16 + co * 16 + ci % 8 * 2
    assert torch.equal(flat[off // 2], want)
    assert torch.equal(torch.sort(off.reshape(-1) // 2).values, torch.arange(flat.numel()))


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
