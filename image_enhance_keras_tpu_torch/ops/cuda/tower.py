"""Chains of Light53 and Light blocks: CUDA kernels and their plain versions.

Counterpart of ``ops/pallas/tower.py``.  ``fused_light53_chain`` and
``fused_light_chain`` keep the JAX signatures: x NHWC, weights stacked on a
leading K axis, (K, kh, kw, C, C) HWIO, biases (K, C).  They check their
arguments and call the ops ``iek::light53_chain`` and ``iek::light_chain``
(``ops/cuda/library.py``): on a CUDA tensor the op runs the K blocks in one
cooperative launch of ``csrc/tower.cu`` (see the notes there;
:func:`launch_light53_chain`, :func:`launch_light_chain`) or raises; on a
CPU tensor it runs the plain PyTorch versions below, loops of ``conv2d_nhwc`` in the chain body's order
(``_light53_body``: ``identity*x + res*(ya + yb)`` with each branch's
second conv and bias summed before the combine).  Each wrapper counts its
kernel launches in ``.launches`` (one per call), those on bf16 tensors also
in ``.bf16_launches``.  An empty chain (K = 0)
returns x, as the JAX block loop does.

x is float32 or bf16 (weights and biases float32), as the TPU chain kernels
take any input dtype.  float32 x runs the convolutions on the TF32 tensor
cores in split precision (3xTF32, :func:`split_tf32`,
``ops/cuda/tf32x3.py``), the weights split and repacked once per weight
tensor (``tf32x3.packed``).  bf16 x runs them on the bf16 tensor cores
(``csrc/conv_bf16.cuh``), the weights cast to bf16 and repacked once
(``bf16.packed``), and rounds to
bf16 after each conv and each step of the combine, as ``_light53_body`` and
``_light_body`` do (:func:`light53_chain_bf16`, :func:`light_chain_bf16`).
The kernels take exactly C = 128 channels.
"""

from __future__ import annotations

import torch

from image_enhance_keras_tpu_torch.ops.conv import conv2d_nhwc
from image_enhance_keras_tpu_torch.ops.cuda import _build, bf16, library
from image_enhance_keras_tpu_torch.ops.cuda.blocks import check_args, device_weights, stream_of
from image_enhance_keras_tpu_torch.ops.cuda.tf32x3 import round_tf32, split_tf32

__all__ = [
    "fused_light53_chain",
    "fused_light_chain",
    "launch_light53_chain",
    "launch_light_chain",
    "light53_chain_bf16",
    "light53_chain_plain",
    "light_chain_bf16",
    "light_chain_plain",
    "round_tf32",
    "split_tf32",
]


def light53_chain_plain(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
                        res_scale: float = 0.1, identity_scale: float = 0.9):
    """K Light53 blocks: x = id*x + res*(ya + yb), with
    ya = conv5(relu(conv3(x) + ba1)) + ba2 and yb = conv3(relu(conv5(x) + bb1)) + bb2;
    bf16 x: :func:`light53_chain_bf16`."""
    if x.dtype == torch.bfloat16:
        return light53_chain_bf16(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2, res_scale, identity_scale)
    for k in range(wa1.shape[0]):
        ya = conv2d_nhwc(torch.relu(conv2d_nhwc(x, wa1[k], ba1[k])), wa2[k], ba2[k])
        yb = conv2d_nhwc(torch.relu(conv2d_nhwc(x, wb1[k], bb1[k])), wb2[k], bb2[k])
        x = identity_scale * x + res_scale * (ya + yb)
    return x


def light_chain_plain(x, wa1, ba1, wa2, ba2, res_scale: float = 0.1):
    """K Light blocks: x = x + res * (conv3(relu(conv3(x) + b1)) + b2);
    bf16 x: :func:`light_chain_bf16`."""
    if x.dtype == torch.bfloat16:
        return light_chain_bf16(x, wa1, ba1, wa2, ba2, res_scale)
    for k in range(wa1.shape[0]):
        x = x + res_scale * conv2d_nhwc(torch.relu(conv2d_nhwc(x, wa1[k], ba1[k])), wa2[k], ba2[k])
    return x


def _bf16_branch(x, w1, b1, w2, b2, sum_dtype):
    """bf16(conv(bf16(relu(conv(x, w1) + b1)), w2) + b2), float32 biases."""
    t = torch.relu(bf16.conv_exact(x, w1, sum_dtype) + b1).to(torch.bfloat16)
    return (bf16.conv_exact(t, w2, sum_dtype) + b2).to(torch.bfloat16)


def light53_chain_bf16(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2, res_scale: float = 0.1,
                       identity_scale: float = 0.9, sum_dtype: torch.dtype = torch.float32):
    """K bf16 Light53 blocks as ``_light53_body`` computes them: bf16 x and
    bf16(weights), exact products summed in ``sum_dtype`` (``bf16.conv_exact``),
    float32 biases; ya and yb round to bf16 after conv and bias, and the
    combine x = id*x + res*(ya + yb) runs in bf16 with the bf16 scales, one
    rounding per operation."""
    ident = torch.tensor(identity_scale, dtype=torch.bfloat16)
    res = torch.tensor(res_scale, dtype=torch.bfloat16)
    for k in range(wa1.shape[0]):
        ya = _bf16_branch(x, wa1[k], ba1[k], wa2[k], ba2[k], sum_dtype)
        yb = _bf16_branch(x, wb1[k], bb1[k], wb2[k], bb2[k], sum_dtype)
        x = ident * x + res * (ya + yb)
    return x


def light_chain_bf16(x, wa1, ba1, wa2, ba2, res_scale: float = 0.1, sum_dtype: torch.dtype = torch.float32):
    """K bf16 Light blocks as ``_light_body`` computes them: u = bf16(conv3(
    bf16(relu(conv3(x) + b1))) + b2); x = x + res*u in bf16, one rounding per operation."""
    res = torch.tensor(res_scale, dtype=torch.bfloat16)
    for k in range(wa1.shape[0]):
        x = x + res * _bf16_branch(x, wa1[k], ba1[k], wa2[k], ba2[k], sum_dtype)
    return x


def _k_blocks(w: torch.Tensor) -> int:
    if w.dim() != 5:
        raise ValueError(f"chain weights are stacked (K, kh, kw, C, C), got shape {tuple(w.shape)}")
    return int(w.shape[0])


def fused_light53_chain(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
                        res_scale: float = 0.1, identity_scale: float = 0.9):
    """K chained Light53 blocks, (N, H, W, C) float32 or bf16, SAME semantics per image."""
    k = _k_blocks(wa1)
    check_args(x, [(wa1, 3), (wa2, 5), (wb1, 5), (wb2, 3)], [ba1, ba2, bb1, bb2], lead=(k,))
    if k == 0:
        return x
    wa1, wa2, wb1, wb2 = device_weights(x, wa1, wa2, wb1, wb2)
    return library.light53_chain(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2, float(res_scale),
                                 float(identity_scale))


def fused_light_chain(x, wa1, ba1, wa2, ba2, res_scale: float = 0.1):
    """K chained Light blocks, (N, H, W, C) float32 or bf16, SAME semantics per image."""
    k = _k_blocks(wa1)
    check_args(x, [(wa1, 3), (wa2, 3)], [ba1, ba2], lead=(k,))
    if k == 0:
        return x
    wa1, wa2 = device_weights(x, wa1, wa2)
    return library.light_chain(x, wa1, ba1, wa2, ba2, float(res_scale))


def launch_light53_chain(x, wa1p, ba1, wa2p, ba2, wb1p, bb1, wb2p, bb2, res_scale: float,
                         identity_scale: float) -> torch.Tensor:
    """K6 on CUDA tensors, the stacked weights packed (``blocks.device_weights``):
    the CUDA implementation of ``iek::light53_chain``."""
    _build.check_aligned(x, wa1p, ba1, wa2p, ba2, wb1p, bb1, wb2p, bb2)
    lib = _build.library("tower")
    k = int(ba1.shape[0])
    n, h, w, c = (int(s) for s in x.shape)
    act, ta, tb, out = (torch.empty_like(x) for _ in range(4))
    if x.dtype == torch.bfloat16:
        fn = lib.iek_light53_chain_bf16
        res_scale, identity_scale = bf16.scalar(res_scale), bf16.scalar(identity_scale)
    else:
        fn = lib.iek_light53_chain
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(),
            wa1p.data_ptr(), ba1.data_ptr(), wa2p.data_ptr(), ba2.data_ptr(),
            wb1p.data_ptr(), bb1.data_ptr(), wb2p.data_ptr(), bb2.data_ptr(),
            act.data_ptr(), ta.data_ptr(), tb.data_ptr(), out.data_ptr(),
            k, n, h, w, c, float(res_scale), float(identity_scale), stream_of(x),
        )
    _build.check(lib, code, "fused_light53_chain")
    fused_light53_chain.launches += 1
    fused_light53_chain.bf16_launches += int(x.dtype == torch.bfloat16)
    return out


def launch_light_chain(x, wa1p, ba1, wa2p, ba2, res_scale: float) -> torch.Tensor:
    """K7 on CUDA tensors, the stacked weights packed: the CUDA implementation of ``iek::light_chain``."""
    _build.check_aligned(x, wa1p, ba1, wa2p, ba2)
    lib = _build.library("tower")
    k = int(ba1.shape[0])
    n, h, w, c = (int(s) for s in x.shape)
    act, t, out = (torch.empty_like(x) for _ in range(3))
    if x.dtype == torch.bfloat16:
        fn, res_scale = lib.iek_light_chain_bf16, bf16.scalar(res_scale)
    else:
        fn = lib.iek_light_chain
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), wa1p.data_ptr(), ba1.data_ptr(), wa2p.data_ptr(), ba2.data_ptr(),
            act.data_ptr(), t.data_ptr(), out.data_ptr(), k, n, h, w, c, float(res_scale), stream_of(x),
        )
    _build.check(lib, code, "fused_light_chain")
    fused_light_chain.launches += 1
    fused_light_chain.bf16_launches += int(x.dtype == torch.bfloat16)
    return out


fused_light53_chain.launches = 0
fused_light53_chain.bf16_launches = 0
fused_light_chain.launches = 0
fused_light_chain.bf16_launches = 0
