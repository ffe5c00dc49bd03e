"""The float32 kernels' split precision (3xTF32) and their packed weights.

The block kernels (``ops/cuda/blocks.py``, K1/K2) and the chain kernels
(``ops/cuda/tower.py``, K6/K7) run every conv on the tile of
``csrc/conv_tf32x3.cuh``: each float32 operand is split into a TF32 hi and
lo (:func:`split_tf32`), and the weights are split and repacked once per
weight tensor into the tile's B operand (:func:`packed`).  The tile's N is
the 128 output channels, so the kernels take exactly C = 128
(:data:`CUDA_CHANNELS`).
"""

from __future__ import annotations

import torch

__all__ = ["CUDA_CHANNELS", "cached_pack", "packed", "round_tf32", "split_tf32"]

#: channels the CUDA kernels take: the N of their wgmma tile
CUDA_CHANNELS = 128


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, ties away
    from zero), as a float32 tensor: the kernels' ``tf32_rna``, bit for bit."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 v -> (hi, lo): hi = round_tf32(v) and lo = v - hi, exact, so
    hi + lo == v.  The kernels multiply hi and round_tf32(lo) (3xTF32)."""
    hi = round_tf32(v)
    return hi, v - hi


def cached_pack(w: torch.Tensor, attr: str, build) -> torch.Tensor:
    """``build(w)``, cached on the weight tensor itself under ``attr``, one
    attribute per product policy (3xTF32 ``_iek_packed``, bf16
    ``_iek_packed_bf16``), so that one policy's pack never serves the other.

    Repacked after an in-place change (the tensor's version counter);
    inference tensors carry no version counter and are not repacked after
    one."""
    version = None if w.is_inference() else w._version
    cached = getattr(w, attr, None)
    if cached is not None and cached[0] == version:
        return cached[1]
    out = build(w.detach())
    setattr(w, attr, (version, out))
    return out


def _pack(w: torch.Tensor) -> torch.Tensor:
    *lead, k, _, cin, cout = (int(s) for s in w.shape)
    hi, lo = split_tf32(w)
    both = torch.stack([hi, round_tf32(lo)], dim=0).reshape(2, -1, k * k, cin // 8, 2, 4, cout)
    return both.permute(1, 2, 3, 0, 4, 6, 5).reshape(*lead, k * k, cin // 8, 2, 2, cout, 4).contiguous()


def packed(w: torch.Tensor) -> torch.Tensor:
    """HWIO weights -> the kernels' B operand: one block's (k, k, C, C) to
    [k*k][C/8][hi/lo][2][C][4] float32, stacked (K, k, k, C, C) to the same
    with a leading [K].

    Each (block, tap, 8-input-channel step) is one contiguous 8 KB tile: the
    hi tile, then the lo tile (``round_tf32`` of :func:`split_tf32`'s lo),
    each K-major, the two 4-channel halves of the step C*16 bytes apart and
    output channel ``co`` holding its 4 input channels at ``co*16``.  Cached
    on the weight tensor itself (:func:`cached_pack`), so a loaded tree
    splits and repacks once.
    """
    return cached_pack(w, "_iek_packed", _pack)
