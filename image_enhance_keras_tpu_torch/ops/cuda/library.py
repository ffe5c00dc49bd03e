"""Every kernel entry a forward reaches, as a ``torch.library`` custom op (namespace ``iek``).

Each op has two implementations and the dispatcher picks between them by
the device of its tensors: on CUDA tensors the kernel's launch
(``launch_*`` of ``ops/cuda/*.py``, which counts the launch), on CPU
tensors the kernel's plain PyTorch version.  Its fake version gives only
the output's shape and dtype, so ``torch.export`` traces a forward through
the op as one opaque ``iek::`` node and the exported program
(``runtime/export.py``) calls the same kernels.

The kernel wrappers (``fused_light53_block``, ``light53_int8_xla``, ...)
check their arguments and call these ops.  Weight arguments are in the
layout of the implementation that runs: HWIO on the CPU, the kernel's
packed layout on CUDA, made once per weight tensor by the wrapper and
cached on it, so that a traced program holds the packed weights as
constants.  Raw pointers, scratch buffers, per-sample abs-maxes and the
launches stay inside the CUDA implementations.

    K1 light53_block, K2 light_block, K6 light53_chain, K7 light_chain
    (float32 and bf16 x); K3 upsample_phase_tf1 (differentiable), K3q
    upsample_quant_tf1 (the x4 with IEK_INT8_UPQ's quantize); K4
    light53_int8, K5 light_int8 (static ``act_scales``, or None: dynamic);
    X1 light53_int8_xla, X1u light53_int8_xla_upq (IEK_INT8_UPQ's first HR
    block), X2 light_int8_xla, X3 light53_int8_xla_dyn (and
    its steps _absmax, _first, _second, for a frame cut into bands); X4
    int8_conv3, int8_conv3_dyn (and its steps int8_conv3_absmax,
    int8_conv3_dyn_given), and the zoo's block forms int8_conv3_codes,
    int8_conv3_light, int8_conv3_diff_b, int8_conv3_diff_d.

Importing this module registers the ops; it imports the kernel modules only
when an op runs, so a process that loads an exported program needs nothing
else of the package.
"""

from typing import Optional

import torch
from torch import Tensor

__all__ = [
    "light53_block", "light_block", "light53_chain", "light_chain", "upsample_phase_tf1",
    "upsample_quant_tf1", "light53_int8", "light_int8", "light53_int8_xla", "light53_int8_xla_upq",
    "light_int8_xla", "light53_int8_xla_dyn",
    "int8_conv3", "int8_conv3_dyn", "light53_int8_xla_dyn_absmax", "light53_int8_xla_dyn_first",
    "light53_int8_xla_dyn_second", "int8_conv3_absmax", "int8_conv3_dyn_given", "int8_conv3_codes",
    "int8_conv3_light", "int8_conv3_diff_b", "int8_conv3_diff_d", "device_layout",
]


def device_layout(x: Tensor, pack, *weights: Tensor) -> list:
    """``weights`` in the layout of the implementation that runs on x's
    device: as given (HWIO) for the plain versions, ``pack(w)`` (cached on
    each weight tensor) for the CUDA kernels."""
    return [pack(w) for w in weights] if x.device.type == "cuda" else list(weights)


def _op(name: str):
    """Register ``fn`` as ``iek::name`` with its CPU implementation."""
    return torch.library.custom_op(f"iek::{name}", mutates_args=(), device_types="cpu")


def _like_x(x, *args, **kwargs):
    return torch.empty_like(x)


# -- K1, K2: one Light53 / Light block (ops/cuda/blocks.py) ---------------------

@_op("light53_block")
def light53_block(x: Tensor, wa1: Tensor, ba1: Tensor, wa2: Tensor, ba2: Tensor, wb1: Tensor, bb1: Tensor,
                  wb2: Tensor, bb2: Tensor, res_scale: float, identity_scale: float) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import blocks

    return blocks.light53_block_plain(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2, res_scale, identity_scale)


@light53_block.register_kernel("cuda")
def _(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2, res_scale, identity_scale):
    from image_enhance_keras_tpu_torch.ops.cuda import blocks

    return blocks.launch_light53_block(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2, res_scale, identity_scale)


@_op("light_block")
def light_block(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, res_scale: float) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import blocks

    return blocks.light_block_plain(x, w1, b1, w2, b2, res_scale)


@light_block.register_kernel("cuda")
def _(x, w1, b1, w2, b2, res_scale):
    from image_enhance_keras_tpu_torch.ops.cuda import blocks

    return blocks.launch_light_block(x, w1, b1, w2, b2, res_scale)


# -- K6, K7: chains of K blocks, weights stacked on a leading K (ops/cuda/tower.py) --

@_op("light53_chain")
def light53_chain(x: Tensor, wa1: Tensor, ba1: Tensor, wa2: Tensor, ba2: Tensor, wb1: Tensor, bb1: Tensor,
                  wb2: Tensor, bb2: Tensor, res_scale: float, identity_scale: float) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import tower

    return tower.light53_chain_plain(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2, res_scale, identity_scale)


@light53_chain.register_kernel("cuda")
def _(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2, res_scale, identity_scale):
    from image_enhance_keras_tpu_torch.ops.cuda import tower

    return tower.launch_light53_chain(x, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2, res_scale, identity_scale)


@_op("light_chain")
def light_chain(x: Tensor, wa1: Tensor, ba1: Tensor, wa2: Tensor, ba2: Tensor, res_scale: float) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import tower

    return tower.light_chain_plain(x, wa1, ba1, wa2, ba2, res_scale)


@light_chain.register_kernel("cuda")
def _(x, wa1, ba1, wa2, ba2, res_scale):
    from image_enhance_keras_tpu_torch.ops.cuda import tower

    return tower.launch_light_chain(x, wa1, ba1, wa2, ba2, res_scale)


# -- K3: the TF1 phase upsample (ops/cuda/upsample.py) ---------------------------

@_op("upsample_phase_tf1")
def upsample_phase_tf1(x: Tensor, factor: int) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_plain

    return upsample_phase_plain(x, factor)


@upsample_phase_tf1.register_kernel("cuda")
def _(x, factor):
    from image_enhance_keras_tpu_torch.ops.cuda import upsample

    return upsample._launch(x, factor)


@upsample_phase_tf1.register_fake
def _(x, factor):
    n, h, w, c = x.shape
    return x.new_empty((n, factor * h, factor * w, c))


def _upsample_setup(ctx, inputs, output):
    x, factor = inputs
    ctx.shape, ctx.dtype, ctx.factor = tuple(x.shape), x.dtype, factor


def _upsample_backward(ctx, g):
    """The op is linear: its gradient is the transpose of the plain
    construction, taken by autograd (as JAX's ``_upsample_pallas_ad``
    differentiates the XLA construction)."""
    from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_plain

    with torch.enable_grad():
        z = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device, requires_grad=True)
        (grad,) = torch.autograd.grad(upsample_phase_plain(z, ctx.factor), z, g)
    return grad, None


upsample_phase_tf1.register_autograd(_upsample_backward, setup_context=_upsample_setup)


@_op("upsample_quant_tf1")
def upsample_quant_tf1(x: Tensor, factor: int, scales: Tensor) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import upsample

    return upsample.upsample_quant_plain(x, factor, scales)


@upsample_quant_tf1.register_kernel("cuda")
def _(x, factor, scales):
    from image_enhance_keras_tpu_torch.ops.cuda import upsample

    return upsample._launch_quant(x, factor, scales)


@upsample_quant_tf1.register_fake
def _(x, factor, scales):
    n, h, w, c = x.shape
    return x.new_empty((n, factor * h, factor * w, c), dtype=torch.int8)


# -- K4, K5: int8 blocks, static or per-window dynamic scales (ops/cuda/int8_blocks.py) --

@_op("light53_int8")
def light53_int8(x: Tensor, wa1q: Tensor, sa1: Tensor, ba1: Tensor, wa2q: Tensor, sa2: Tensor, ba2: Tensor,
                 wb1q: Tensor, sb1: Tensor, bb1: Tensor, wb2q: Tensor, sb2: Tensor, bb2: Tensor,
                 res_scale: float, identity_scale: float, tile: list[int],
                 act_scales: Optional[Tensor]) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as k

    convs = (wa1q, sa1, ba1, wa2q, sa2, ba2, wb1q, sb1, bb1, wb2q, sb2, bb2)
    if act_scales is None:
        return k.light53_int8_dynamic_plain(x, *convs, tuple(tile), res_scale, identity_scale)
    return k.light53_int8_plain(x, *convs, act_scales, res_scale, identity_scale)


@light53_int8.register_kernel("cuda")
def _(x, wa1q, sa1, ba1, wa2q, sa2, ba2, wb1q, sb1, bb1, wb2q, sb2, bb2, res_scale, identity_scale, tile,
      act_scales):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as k

    return k.launch_light53_int8(x, wa1q, sa1, ba1, wa2q, sa2, ba2, wb1q, sb1, bb1, wb2q, sb2, bb2,
                                 res_scale, identity_scale, tile, act_scales)


@_op("light_int8")
def light_int8(x: Tensor, w1q: Tensor, s1: Tensor, b1: Tensor, w2q: Tensor, s2: Tensor, b2: Tensor,
               res_scale: float, tile: list[int], act_scales: Optional[Tensor]) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as k

    if act_scales is None:
        return k.light_int8_dynamic_plain(x, w1q, s1, b1, w2q, s2, b2, tuple(tile), res_scale)
    return k.light_int8_plain(x, w1q, s1, b1, w2q, s2, b2, act_scales, res_scale)


@light_int8.register_kernel("cuda")
def _(x, w1q, s1, b1, w2q, s2, b2, res_scale, tile, act_scales):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as k

    return k.launch_light_int8(x, w1q, s1, b1, w2q, s2, b2, res_scale, tile, act_scales)


# -- X1, X2, X3: the --forward int8 blocks (ops/cuda/int8_xla.py) ------------------

@_op("light53_int8_xla")
def light53_int8_xla(x: Tensor, wa1: Tensor, sa1: Tensor, ba1: Tensor, wa2: Tensor, sa2: Tensor, ba2: Tensor,
                     wb1: Tensor, sb1: Tensor, bb1: Tensor, wb2: Tensor, sb2: Tensor, bb2: Tensor,
                     act_scales: Tensor, acc: str, emit_s8: bool, res_scale: float,
                     identity_scale: float, merge55: bool) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.light53_int8_xla_plain(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, act_scales,
                                    acc, emit_s8, res_scale, identity_scale, merge55)


@light53_int8_xla.register_kernel("cuda")
def _(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, act_scales, acc, emit_s8, res_scale,
      identity_scale, merge55):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.launch_light53_int8_xla(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, act_scales,
                                     acc, res_scale, identity_scale)


@_op("light53_int8_xla_upq")
def light53_int8_xla_upq(xq: Tensor, h_lr: Tensor, wa1: Tensor, sa1: Tensor, ba1: Tensor, wa2: Tensor,
                         sa2: Tensor, ba2: Tensor, wb1: Tensor, sb1: Tensor, bb1: Tensor, wb2: Tensor,
                         sb2: Tensor, bb2: Tensor, act_scales: Tensor, acc: str, emit_s8: bool,
                         res_scale: float, factor: int) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.light53_int8_xla_upq_plain(xq, h_lr, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2,
                                        act_scales, acc, emit_s8, res_scale, factor)


@light53_int8_xla_upq.register_kernel("cuda")
def _(xq, h_lr, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, act_scales, acc, emit_s8,
      res_scale, factor):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.launch_light53_int8_xla_upq(xq, h_lr, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2,
                                         act_scales, acc, res_scale, factor)


@light53_int8_xla_upq.register_fake
def _(xq, h_lr, *args):
    return xq.new_empty(xq.shape, dtype=torch.bfloat16)


@_op("light_int8_xla")
def light_int8_xla(x: Tensor, w1: Tensor, s1: Tensor, b1: Tensor, w2: Tensor, s2: Tensor, b2: Tensor,
                   act_scales: Tensor, acc: str, emit_s8: bool, res_scale: float) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.light_int8_xla_plain(x, w1, s1, b1, w2, s2, b2, act_scales, acc, emit_s8, res_scale)


@light_int8_xla.register_kernel("cuda")
def _(x, w1, s1, b1, w2, s2, b2, act_scales, acc, emit_s8, res_scale):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.launch_light_int8_xla(x, w1, s1, b1, w2, s2, b2, act_scales, acc, res_scale)


@_op("light53_int8_xla_dyn")
def light53_int8_xla_dyn(x: Tensor, wa1: Tensor, sa1: Tensor, ba1: Tensor, wa2: Tensor, sa2: Tensor,
                         ba2: Tensor, wb1: Tensor, sb1: Tensor, bb1: Tensor, wb2: Tensor, sb2: Tensor,
                         bb2: Tensor, acc: str, res_scale: float, identity_scale: float, merge55: bool) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.light53_int8_xla_dyn_plain(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, acc,
                                        res_scale, identity_scale, merge55)


@light53_int8_xla_dyn.register_kernel("cuda")
def _(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, acc, res_scale, identity_scale, merge55):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.launch_light53_int8_xla_dyn(x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, acc,
                                         res_scale, identity_scale)


# X3 in steps, for a frame cut into bands whose abs-maxes are reduced over the
# bands between the steps (``int8_xla.light53_int8_xla_dyn_banded``)

@_op("light53_int8_xla_dyn_absmax")
def light53_int8_xla_dyn_absmax(x: Tensor) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.sample_absmax(x)


@light53_int8_xla_dyn_absmax.register_kernel("cuda")
def _(x):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.launch_light53_int8_xla_dyn_absmax(x)


@light53_int8_xla_dyn_absmax.register_fake
def _(x):
    return x.new_empty((x.shape[0],), dtype=torch.float32)


@_op("light53_int8_xla_dyn_first")
def light53_int8_xla_dyn_first(x: Tensor, wa1: Tensor, sa1: Tensor, ba1: Tensor, wb1: Tensor, sb1: Tensor,
                               bb1: Tensor, amax_x: Tensor, acc: str, window: list[int],
                               merge55: bool) -> tuple[Tensor, Tensor, Tensor]:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.light53_int8_xla_dyn_first_plain(x, wa1, sa1, ba1, wb1, sb1, bb1, amax_x, acc, tuple(window),
                                              merge55)


@light53_int8_xla_dyn_first.register_kernel("cuda")
def _(x, wa1, sa1, ba1, wb1, sb1, bb1, amax_x, acc, window, merge55):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.launch_light53_int8_xla_dyn_first(x, wa1, sa1, ba1, wb1, sb1, bb1, amax_x, acc, window)


@light53_int8_xla_dyn_first.register_fake
def _(x, *args):
    t = x.new_empty(x.shape, dtype=torch.float32)
    return t, torch.empty_like(t), x.new_empty((2, x.shape[0]), dtype=torch.float32)


@_op("light53_int8_xla_dyn_second")
def light53_int8_xla_dyn_second(x: Tensor, ta: Tensor, tb: Tensor, wa2: Tensor, sa2: Tensor, ba2: Tensor,
                                wb2: Tensor, sb2: Tensor, bb2: Tensor, amax_ab: Tensor, acc: str, res_scale: float,
                                identity_scale: float) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.light53_int8_xla_dyn_second_plain(x, ta, tb, wa2, sa2, ba2, wb2, sb2, bb2, amax_ab, acc, res_scale,
                                               identity_scale)


@light53_int8_xla_dyn_second.register_kernel("cuda")
def _(x, ta, tb, wa2, sa2, ba2, wb2, sb2, bb2, amax_ab, acc, res_scale, identity_scale):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.launch_light53_int8_xla_dyn_second(x, ta, tb, wa2, sa2, ba2, wb2, sb2, bb2, amax_ab, acc, res_scale,
                                                identity_scale)


# -- X4: the zoo's 3x3 int8 conv (ops/cuda/int8_conv.py) -------------------------
# ``act_kind`` 0: none, 1: relu, 2: leaky with ``slope``

@_op("int8_conv3")
def int8_conv3(x: Tensor, wq: Tensor, sf: Tensor, bias: Tensor, s_in: Tensor, acc: str, act_kind: int,
               slope: float) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.int8_conv3_plain(x, wq, sf, bias, s_in, acc, k.act_of(act_kind, slope))


@int8_conv3.register_kernel("cuda")
def _(x, wq, sf, bias, s_in, acc, act_kind, slope):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.launch_int8_conv3(x, wq, sf, bias, s_in, acc, act_kind, slope)


@_op("int8_conv3_dyn")
def int8_conv3_dyn(x: Tensor, wq: Tensor, s_w: Tensor, bias: Tensor, acc: str, act_kind: int,
                   slope: float) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.int8_conv3_dyn_plain(x, wq, s_w, bias, acc, k.act_of(act_kind, slope))


@int8_conv3_dyn.register_kernel("cuda")
def _(x, wq, s_w, bias, acc, act_kind, slope):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.launch_int8_conv3_dyn(x, wq, s_w, bias, acc, act_kind, slope)


# X4's dynamic form in two steps, for a banded frame (``int8_conv.int8_conv3_dyn_banded``)

@_op("int8_conv3_absmax")
def int8_conv3_absmax(x: Tensor, wq: Tensor, s_w: Tensor, bias: Tensor) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as k

    return k.sample_absmax(x)


@int8_conv3_absmax.register_kernel("cuda")
def _(x, wq, s_w, bias):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.launch_int8_conv3_absmax(x, wq, s_w, bias)


@int8_conv3_absmax.register_fake
def _(x, *args):
    return x.new_empty((x.shape[0],), dtype=torch.float32)


@_op("int8_conv3_dyn_given")
def int8_conv3_dyn_given(x: Tensor, wq: Tensor, s_w: Tensor, bias: Tensor, amax: Tensor, acc: str,
                         act_kind: int, slope: float) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.int8_conv3_dyn_plain(x, wq, s_w, bias, acc, k.act_of(act_kind, slope), amax=amax)


@int8_conv3_dyn_given.register_kernel("cuda")
def _(x, wq, s_w, bias, amax, acc, act_kind, slope):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.launch_int8_conv3_dyn_given(x, wq, s_w, bias, amax, acc, act_kind, slope)


# X4's block forms: the zoo's convs from and to int8 codes, with the blocks' combines

@_op("int8_conv3_codes")
def int8_conv3_codes(x: Tensor, wq: Tensor, sf: Tensor, bias: Tensor, s_in: Optional[Tensor], s_out: Tensor,
                     acc: str, act_kind: int, slope: float) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.int8_conv3_codes_plain(x, wq, sf, bias, s_in, s_out, acc, k.act_of(act_kind, slope))


@int8_conv3_codes.register_kernel("cuda")
def _(x, wq, sf, bias, s_in, s_out, acc, act_kind, slope):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.launch_int8_conv3_codes(x, wq, sf, bias, s_in, s_out, acc, act_kind, slope)


@int8_conv3_codes.register_fake
def _(x, wq, sf, *args):
    n, h, w, _ = x.shape
    return x.new_empty((n, h, w, sf.shape[0]), dtype=torch.int8)


@_op("int8_conv3_light")
def int8_conv3_light(xq: Tensor, wq: Tensor, sf: Tensor, bias: Tensor, x: Tensor, acc: str) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.int8_conv3_light_plain(xq, wq, sf, bias, x, acc)


@int8_conv3_light.register_kernel("cuda")
def _(xq, wq, sf, bias, x, acc):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.launch_int8_conv3_light(xq, wq, sf, bias, x, acc)


@_op("int8_conv3_diff_b")
def int8_conv3_diff_b(xq: Tensor, wq: Tensor, sf: Tensor, bias: Tensor, x: Tensor, s_d: Tensor,
                      acc: str) -> tuple[Tensor, Tensor]:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.int8_conv3_diff_b_plain(xq, wq, sf, bias, x, s_d, acc)


@int8_conv3_diff_b.register_kernel("cuda")
def _(xq, wq, sf, bias, x, s_d, acc):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.launch_int8_conv3_diff_b(xq, wq, sf, bias, x, s_d, acc)


@int8_conv3_diff_b.register_fake
def _(xq, wq, sf, bias, x, *args):
    return x.new_empty(x.shape, dtype=torch.float32), x.new_empty(x.shape, dtype=torch.int8)


@_op("int8_conv3_diff_d")
def int8_conv3_diff_d(xq: Tensor, wq: Tensor, sf: Tensor, bias: Tensor, x: Tensor, t: Tensor, acc: str) -> Tensor:
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.int8_conv3_diff_d_plain(xq, wq, sf, bias, x, t, acc)


@int8_conv3_diff_d.register_kernel("cuda")
def _(xq, wq, sf, bias, x, t, acc):
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as k

    return k.launch_int8_conv3_diff_d(xq, wq, sf, bias, x, t, acc)


def _block_out(xq, wq, sf, bias, x, *args):
    return torch.empty_like(x)


def _conv_out(x, wq, scale, *args):
    n, h, w, _ = x.shape
    return x.new_empty((n, h, w, scale.shape[0]), dtype=torch.float32)


for _o in (light53_block, light_block, light53_chain, light_chain, light53_int8, light_int8,
           light53_int8_xla, light_int8_xla, light53_int8_xla_dyn):
    _o.register_fake(_like_x)
int8_conv3.register_fake(_conv_out)
int8_conv3_dyn.register_fake(_conv_out)
int8_conv3_dyn_given.register_fake(_conv_out)
int8_conv3_light.register_fake(_block_out)
int8_conv3_diff_d.register_fake(_block_out)

