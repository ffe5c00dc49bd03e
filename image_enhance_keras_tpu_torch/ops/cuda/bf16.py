"""The bf16 kernels' product policy: bf16 operands, exact products, float32 sums.

The block kernels (``ops/cuda/blocks.py``, K1/K2) and the chain kernels
(``ops/cuda/tower.py``, K6/K7) take bf16 activations as the TPU kernels do
(``ops/pallas/blocks.py`` and ``ops/pallas/tower.py`` cast the weights to
x's dtype and sum in float32).  On the card every conv runs on the bf16
tile of ``csrc/conv_bf16.cuh`` (one bf16 wgmma per 16 input channels, a
tap's 8 in one chain, one rounded float32 add per tap); :func:`packed`
casts the float32 weights to bf16 (round to nearest even) and repacks them
once per weight tensor into that tile's B operand.

A product of two bf16 values is exact in float32, so the plain versions
compute each conv as :func:`conv_exact`: the bf16 values held in float32
(or float64, for a yardstick of summation order), summed per tap and then
over the taps, so that its only rounding is the sums'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from image_enhance_keras_tpu_torch.ops.cuda.tf32x3 import cached_pack

__all__ = ["conv_exact", "packed", "scalar", "ulp_gaps"]


def scalar(v: float) -> float:
    """A scale as the bf16 kernels multiply by it: its bf16 value (0.9 ->
    0.8984375, 0.1 -> 0.10009765625), as JAX's ``jnp.asarray(v, bf16)``."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


def conv_exact(x: torch.Tensor, w: torch.Tensor, sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """SAME conv of bf16 activations with bf16(w), float32 out, summed as the
    kernels and the TPU kernels' ``_conv_shifted`` sum it: one product over
    the input channels per tap, the taps added in order (dy, then dx).
    Every product is exact; the sums run in ``sum_dtype`` (float32: the
    kernels' arithmetic, in another order within a tap; float64: nearly
    exact) and round once to float32 at the end.  On CUDA tensors a float32
    sum needs TF32 off (``engine.disable_tf32``)."""
    k = int(w.shape[0])
    p = k // 2
    h, wd = int(x.shape[1]), int(x.shape[2])
    xs = F.pad(x.to(sum_dtype), (0, 0, p, p, p, p))
    ws = w.to(torch.bfloat16).to(sum_dtype)
    acc = None
    for dy in range(k):
        for dx in range(k):
            part = xs[:, dy:dy + h, dx:dx + wd, :] @ ws[dy, dx]
            acc = part if acc is None else acc + part
    return acc.to(torch.float32)


def ulp_gaps(got: torch.Tensor, want: torch.Tensor, near_zero: float) -> tuple[float, float]:
    """(share of the elements that differ, largest gap in bf16 ulps) of two
    bf16 results of the same function summed in other orders.  A gap counts
    in ulps of the larger magnitude of its pair, a magnitude taken as at
    least ``near_zero * max|want|``: an output near zero is a sum that
    cancelled, and an intermediate that rounded the other way moves it by an
    ulp of its terms, not of itself."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    m = torch.maximum(torch.maximum(g.abs(), w.abs()), near_zero * w.abs().max())
    ulp = torch.exp2(torch.floor(torch.log2(m.clamp_min(torch.finfo(torch.float32).tiny))).clamp_min(-126) - 7)
    return (d > 0).float().mean().item(), (d / ulp).max().item()


def _pack(w: torch.Tensor) -> torch.Tensor:
    *lead, k, _, cin, cout = (int(s) for s in w.shape)
    b = w.to(torch.bfloat16).reshape(-1, k * k, cin // 16, 2, 8, cout)
    return b.permute(0, 1, 2, 3, 5, 4).reshape(*lead, k * k, cin // 16, 2, cout, 8).contiguous()


def packed(w: torch.Tensor) -> torch.Tensor:
    """float32 HWIO weights -> the bf16 kernels' B operand: one block's
    (k, k, C, C) to [k*k][C/16][2][C][8] bf16, stacked (K, k, k, C, C) to
    the same with a leading [K].

    Each (block, tap, 16-input-channel step) is one contiguous 4 KB tile,
    K-major: the two 8-channel halves of the step C*16 bytes apart, output
    channel ``co`` holding its 8 input channels at ``co*16``; a tap's 8
    tiles are two 16 KB slots of the kernels' weight ring, 4 tiles each.  Cast with round
    to nearest even and cached on the weight tensor itself under its own
    attribute (``tf32x3.cached_pack``), apart from the 3xTF32 pack.
    """
    return cached_pack(w, "_iek_packed_bf16", _pack)
