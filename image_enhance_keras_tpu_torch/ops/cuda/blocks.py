"""Fused Light53 and Light residual blocks: CUDA kernels and their plain versions.

Counterpart of ``ops/pallas/blocks.py``.  ``fused_light53_block`` and
``fused_light_block`` keep the JAX signatures (x NHWC, weights HWIO).  On a
CUDA tensor they launch the kernels of ``csrc/blocks.cu`` (two launches per
block, see the notes there) or raise; on a CPU tensor they run the plain
PyTorch versions below, which repeat the kernels' arithmetic with
``F.conv2d``.  Each wrapper counts in ``.launches`` the blocks it ran on
the kernels (one per call, two CUDA launches each).

The kernels run the convolutions on the TF32 tensor cores in split
precision (3xTF32, ``tf32x3.split_tf32``) and take exactly C = 128
channels on CUDA tensors; their weights are split and repacked once per
weight tensor (``tf32x3.packed``).  On CPU tensors any C is taken.
"""

from __future__ import annotations

import torch

from image_enhance_keras_tpu_torch.ops.conv import conv2d_nhwc
from image_enhance_keras_tpu_torch.ops.cuda import _build
from image_enhance_keras_tpu_torch.ops.cuda.tf32x3 import CUDA_CHANNELS, packed

__all__ = [
    "fused_light53_block",
    "fused_light_block",
    "light53_block_plain",
    "light_block_plain",
]

def light53_block_plain(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
                        res_scale: float = 0.1, identity_scale: float = 0.9):
    """res*((id/res)*x + ba2 + bb2 + conv5(relu(conv3(x)+ba1)) + conv3(relu(conv5(x)+bb1)))."""
    ta = torch.relu(conv2d_nhwc(x, wa1, ba1))
    tb = torch.relu(conv2d_nhwc(x, wb1, bb1))
    acc = (identity_scale / res_scale) * x + (ba2 + bb2)
    acc = acc + conv2d_nhwc(ta, wa2)
    acc = acc + conv2d_nhwc(tb, wb2)
    return res_scale * acc


def light_block_plain(x, w1, b1, w2, b2, res_scale: float = 0.1):
    """x + res * (conv3(relu(conv3(x) + b1)) + b2)."""
    t = torch.relu(conv2d_nhwc(x, w1, b1))
    return x + res_scale * conv2d_nhwc(t, w2, b2)


def check_args(x: torch.Tensor, kernels, biases, lead: tuple = ()) -> None:
    """Validate what both paths take; on CUDA also what the kernels take.

    ``kernels`` are (w, k) pairs of (*lead, k, k, C, C) HWIO weights,
    ``biases`` (*lead, C); ``lead`` is (K,) for stacked chain weights."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got shape {tuple(x.shape)}")
    c = int(x.shape[-1])
    for w, k in kernels:
        if tuple(w.shape) != (*lead, k, k, c, c):
            raise ValueError(f"kernel shape {tuple(w.shape)} != {(*lead, k, k, c, c)}")
    for b in biases:
        if tuple(b.shape) != (*lead, c):
            raise ValueError(f"bias shape {tuple(b.shape)} != {(*lead, c)}")
    tensors = [x, *(w for w, _ in kernels), *biases]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"fused blocks take float32 tensors, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got one on {t.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"fused blocks run on cpu or cuda tensors, not {x.device}")
    if c != CUDA_CHANNELS:
        raise ValueError(f"the CUDA kernels take C == {CUDA_CHANNELS}, got C={c}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernels take 16-byte aligned tensors")


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def fused_light53_block(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
                        res_scale: float = 0.1, identity_scale: float = 0.9):
    """Batched Light53 block, (N, H, W, C) float32, SAME semantics."""
    check_args(x, [(wa1, 3), (wa2, 5), (wb1, 5), (wb2, 3)], [ba1, ba2, bb1, bb2])
    if x.device.type == "cpu":
        return light53_block_plain(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
                                   res_scale, identity_scale)
    lib = _build.library("blocks")
    n, h, w, c = (int(s) for s in x.shape)
    ta, tb, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.iek_light53_block(
            x.data_ptr(),
            packed(wa1).data_ptr(), ba1.data_ptr(), packed(wa2).data_ptr(), ba2.data_ptr(),
            packed(wb1).data_ptr(), bb1.data_ptr(), packed(wb2).data_ptr(), bb2.data_ptr(),
            ta.data_ptr(), tb.data_ptr(), out.data_ptr(),
            n, h, w, c, float(res_scale), float(identity_scale / res_scale), stream_of(x),
        )
    _build.check(lib, code, "fused_light53_block")
    fused_light53_block.launches += 1
    return out


def fused_light_block(x, w1, b1, w2, b2, res_scale: float = 0.1):
    """Batched Light block, (N, H, W, C) float32, SAME semantics."""
    check_args(x, [(w1, 3), (w2, 3)], [b1, b2])
    if x.device.type == "cpu":
        return light_block_plain(x, w1, b1, w2, b2, res_scale)
    lib = _build.library("blocks")
    n, h, w, c = (int(s) for s in x.shape)
    t, out = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.iek_light_block(
            x.data_ptr(), packed(w1).data_ptr(), b1.data_ptr(), packed(w2).data_ptr(), b2.data_ptr(),
            t.data_ptr(), out.data_ptr(), n, h, w, c, float(res_scale), stream_of(x),
        )
    _build.check(lib, code, "fused_light_block")
    fused_light_block.launches += 1
    return out


fused_light53_block.launches = 0
fused_light_block.launches = 0
