"""Fused Light53 and Light residual blocks: CUDA kernels and their plain versions.

Counterpart of ``ops/pallas/blocks.py``.  ``fused_light53_block`` and
``fused_light_block`` keep the JAX signatures (x NHWC, weights HWIO).  They
check their arguments and call the ops ``iek::light53_block`` and
``iek::light_block`` (``ops/cuda/library.py``): on a CUDA tensor the op
launches the kernels of ``csrc/blocks.cu`` (two launches per block, see the
notes there; :func:`launch_light53_block`, :func:`launch_light_block`) or
raises; on a CPU tensor it runs the plain PyTorch versions below, which
repeat the kernels' arithmetic with ``F.conv2d``.  Each wrapper counts in
``.launches`` the blocks its op ran on the kernels (one per call, two CUDA
launches each), and in ``.bf16_launches`` those of them on bf16 tensors.

x is float32 or bf16, as the TPU kernels take any input dtype; weights and
biases are float32.  float32 x runs the convolutions on the TF32 tensor
cores in split precision (3xTF32, ``tf32x3.split_tf32``), the weights split
and repacked once per weight tensor (``tf32x3.packed``).  bf16 x runs them
on the bf16 tensor cores (``csrc/conv_bf16.cuh``), the weights cast to
bf16 and repacked once (``bf16.packed``), the biases float32; ta and tb
round to bf16, the combine is float32 and only the output rounds to bf16,
as ``_light53_kernel`` and ``_light_kernel`` do (:func:`light53_block_bf16`,
:func:`light_block_bf16`).
The kernels take exactly C = 128 channels on CUDA tensors; on CPU tensors
any C is taken.
"""

from __future__ import annotations

import functools

import torch

from image_enhance_keras_tpu_torch.ops.conv import conv2d_nhwc
from image_enhance_keras_tpu_torch.ops.cuda import _build, bf16, library
from image_enhance_keras_tpu_torch.ops.cuda.tf32x3 import CUDA_CHANNELS, packed

__all__ = [
    "fused_light53_block",
    "fused_light_block",
    "launch_light53_block",
    "launch_light_block",
    "light53_block_bf16",
    "light53_block_plain",
    "light_block_bf16",
    "light_block_plain",
]

#: activation dtypes the wrappers take (weights and biases: float32)
DTYPES = (torch.float32, torch.bfloat16)


def light53_block_plain(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
                        res_scale: float = 0.1, identity_scale: float = 0.9):
    """res*((id/res)*x + ba2 + bb2 + conv5(relu(conv3(x)+ba1)) + conv3(relu(conv5(x)+bb1)));
    bf16 x: :func:`light53_block_bf16`."""
    if x.dtype == torch.bfloat16:
        return light53_block_bf16(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2, res_scale, identity_scale)
    ta = torch.relu(conv2d_nhwc(x, wa1, ba1))
    tb = torch.relu(conv2d_nhwc(x, wb1, bb1))
    acc = (identity_scale / res_scale) * x + (ba2 + bb2)
    acc = acc + conv2d_nhwc(ta, wa2)
    acc = acc + conv2d_nhwc(tb, wb2)
    return res_scale * acc


def light_block_plain(x, w1, b1, w2, b2, res_scale: float = 0.1):
    """x + res * (conv3(relu(conv3(x) + b1)) + b2); bf16 x: :func:`light_block_bf16`."""
    if x.dtype == torch.bfloat16:
        return light_block_bf16(x, w1, b1, w2, b2, res_scale)
    t = torch.relu(conv2d_nhwc(x, w1, b1))
    return x + res_scale * conv2d_nhwc(t, w2, b2)


def light53_block_bf16(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
                       res_scale: float = 0.1, identity_scale: float = 0.9,
                       sum_dtype: torch.dtype = torch.float32):
    """The bf16 Light53 block as ``_light53_kernel`` computes it: bf16 x and
    bf16(weights), exact products summed in ``sum_dtype`` (``bf16.conv_exact``),
    float32 biases; ta = bf16(relu(conv3(x) + ba1)), tb = bf16(relu(conv5(x)
    + bb1)); acc = (id/res)*x + (ba2 + bb2), + conv5(ta), + conv3(tb) in
    float32; out = bf16(res * acc)."""
    conv = functools.partial(bf16.conv_exact, sum_dtype=sum_dtype)
    ta = torch.relu(conv(x, wa1) + ba1).to(torch.bfloat16)
    tb = torch.relu(conv(x, wb1) + bb1).to(torch.bfloat16)
    acc = (identity_scale / res_scale) * x.float() + (ba2 + bb2)
    acc = acc + conv(ta, wa2)
    acc = acc + conv(tb, wb2)
    return (res_scale * acc).to(torch.bfloat16)


def light_block_bf16(x, w1, b1, w2, b2, res_scale: float = 0.1, sum_dtype: torch.dtype = torch.float32):
    """The bf16 Light block as ``_light_kernel`` computes it: t = bf16(relu(
    conv3(x) + b1)); out = bf16(x + res * (conv3(t) + b2)), the combine in float32."""
    t = torch.relu(bf16.conv_exact(x, w1, sum_dtype) + b1).to(torch.bfloat16)
    return (x.float() + res_scale * (bf16.conv_exact(t, w2, sum_dtype) + b2)).to(torch.bfloat16)


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
    if x.dtype not in DTYPES:
        raise TypeError(f"fused blocks take float32 or bfloat16 activations, got {x.dtype}")
    tensors = [x, *(w for w, _ in kernels), *biases]
    for t in tensors:
        if t is not x and t.dtype != torch.float32:
            raise TypeError(f"fused blocks take float32 weights and biases, got {t.dtype}")
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


def device_weights(x: torch.Tensor, *weights: torch.Tensor) -> list:
    """The weights for the op on x's device: HWIO for the plain versions, on
    CUDA the packed B operand of x's dtype (``bf16.packed`` or the 3xTF32
    ``tf32x3.packed``)."""
    return library.device_layout(x, bf16.packed if x.dtype == torch.bfloat16 else packed, *weights)


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def fused_light53_block(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
                        res_scale: float = 0.1, identity_scale: float = 0.9):
    """Batched Light53 block, (N, H, W, C) float32 or bf16, SAME semantics."""
    check_args(x, [(wa1, 3), (wa2, 5), (wb1, 5), (wb2, 3)], [ba1, ba2, bb1, bb2])
    wa1, wa2, wb1, wb2 = device_weights(x, wa1, wa2, wb1, wb2)
    return library.light53_block(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2, float(res_scale),
                                 float(identity_scale))


def fused_light_block(x, w1, b1, w2, b2, res_scale: float = 0.1):
    """Batched Light block, (N, H, W, C) float32 or bf16, SAME semantics."""
    check_args(x, [(w1, 3), (w2, 3)], [b1, b2])
    w1, w2 = device_weights(x, w1, w2)
    return library.light_block(x, w1, b1, w2, b2, float(res_scale))


def launch_light53_block(x, wa1p, ba1, wa2p, ba2, wb1p, bb1, wb2p, bb2, res_scale: float,
                         identity_scale: float) -> torch.Tensor:
    """K1 on CUDA tensors, the weights packed (:func:`device_weights`): the
    CUDA implementation of ``iek::light53_block``."""
    _build.check_aligned(x, wa1p, ba1, wa2p, ba2, wb1p, bb1, wb2p, bb2)
    lib = _build.library("blocks")
    n, h, w, c = (int(s) for s in x.shape)
    ta, tb, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    fn = lib.iek_light53_block_bf16 if x.dtype == torch.bfloat16 else lib.iek_light53_block
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(),
            wa1p.data_ptr(), ba1.data_ptr(), wa2p.data_ptr(), ba2.data_ptr(),
            wb1p.data_ptr(), bb1.data_ptr(), wb2p.data_ptr(), bb2.data_ptr(),
            ta.data_ptr(), tb.data_ptr(), out.data_ptr(),
            n, h, w, c, float(res_scale), float(identity_scale / res_scale), stream_of(x),
        )
    _build.check(lib, code, "fused_light53_block")
    fused_light53_block.launches += 1
    fused_light53_block.bf16_launches += int(x.dtype == torch.bfloat16)
    return out


def launch_light_block(x, w1p, b1, w2p, b2, res_scale: float) -> torch.Tensor:
    """K2 on CUDA tensors, the weights packed: the CUDA implementation of ``iek::light_block``."""
    _build.check_aligned(x, w1p, b1, w2p, b2)
    lib = _build.library("blocks")
    n, h, w, c = (int(s) for s in x.shape)
    t, out = torch.empty_like(x), torch.empty_like(x)
    fn = lib.iek_light_block_bf16 if x.dtype == torch.bfloat16 else lib.iek_light_block
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), w1p.data_ptr(), b1.data_ptr(), w2p.data_ptr(), b2.data_ptr(),
            t.data_ptr(), out.data_ptr(), n, h, w, c, float(res_scale), stream_of(x),
        )
    _build.check(lib, code, "fused_light_block")
    fused_light_block.launches += 1
    fused_light_block.bf16_launches += int(x.dtype == torch.bfloat16)
    return out


fused_light53_block.launches = 0
fused_light53_block.bf16_launches = 0
fused_light_block.launches = 0
fused_light_block.bf16_launches = 0
