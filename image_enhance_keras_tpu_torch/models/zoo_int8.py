"""The ``--forward int8`` forwards of the zoo (mirror of ``models/zoo_int8.py``).

The didbl branch (both heads) is ``models/didbl_pallas.py``'s
``apply_didbl_int8_xla``.  difv4 and difvdsr: every residual-block conv is
an int8 convolution over per-channel calibrated codes, the input-channel
scales folded into the weights ("qf"), on X4 (``ops/cuda/int8_conv.py``),
with the activation after it.  Each block runs on X4's block forms: the
first conv quantizes the block input while staging it, every conv after it
reads the int8 codes its predecessor emitted, and the last conv's epilogue
computes the block's combine, so only the block output (and a DiffBlock's
float32 t, which JAX's combine reads) leaves the chip.  The skip paths,
the x2 upsamples (on K3 for CUDA tensors) and the entry and out convs stay
in bf16 / float32 torch, as JAX leaves them to XLA.  The accumulator is
``IEK_INT8_ACC``, read at call time.
"""

from __future__ import annotations

from typing import Any

import torch

from image_enhance_keras_tpu_torch.models import didbl_pallas as dp
from image_enhance_keras_tpu_torch.models.didbl_pallas import _conv, _int8_acc
from image_enhance_keras_tpu_torch.ops.cuda.int8_blocks import quantize_weights_per_channel
from image_enhance_keras_tpu_torch.ops.cuda.int8_conv import (_act, int8_conv3_codes, int8_conv3_diff_b,
                                                             int8_conv3_diff_d, int8_conv3_light)
from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_tf1
from image_enhance_keras_tpu_torch.utils.profiling import SPAN_BLOCK, SPAN_UPSAMPLE, span

__all__ = [
    "int8_support",
    "quantize_difv4_params",
    "apply_difv4_int8",
    "apply_difv4_int8_body",
    "apply_difv4_int8_tail",
    "quantize_difvdsr_params",
    "apply_difvdsr_int8",
]

_F32 = torch.float32
#: the LightBlock leaky slope of difv4's head tower
_DIFV4_LEAKY_HEAD = 0.001
#: difvdsr's DiffBlock leaky slope
_DSR_LEAKY = 0.2


def int8_support(module):
    """``(quantize_fn, apply_fn, body_fn, tail_fn)`` of ``forward='int8'``,
    bound to the module's config, or None when the model has no int8 path;
    body and tail are None where the model has no split."""
    cls = type(module).__name__
    if cls == "DifvdsrDouble":
        ups = module.upsampler
        kw = dict(n_body53=module.n_body53, n_light=module.n_light, n_tail53=module.n_tail53)
        return (
            lambda params, calib: dp.quantize_didbl_params(params, calib_x=calib, scale=module.scale,
                                                           upsampler=ups, **kw),
            lambda qp, x: dp.apply_didbl_int8_xla(qp, x, scale=module.scale, upsampler=ups, **kw),
            lambda qp, x: dp.apply_didbl_int8_xla_body(qp, x, n_body53=module.n_body53,
                                                       n_light=module.n_light),
            lambda qp, h: dp.apply_didbl_int8_xla_tail(qp, h, n_tail53=module.n_tail53,
                                                       scale=module.scale, upsampler=ups),
        )
    if cls == "Difvdsr4":
        kw = dict(n_head=module.n_head, n_mid=module.n_mid, n_tail=module.n_tail, scale=module.scale)
        return (
            lambda params, calib: quantize_difv4_params(params, calib, **kw),
            lambda qp, x: apply_difv4_int8(qp, x, **kw),
            lambda qp, x: apply_difv4_int8_body(qp, x, n_head=module.n_head, n_mid=module.n_mid),
            lambda qp, h: apply_difv4_int8_tail(qp, h, n_tail=module.n_tail, scale=module.scale),
        )
    if cls == "Difvdsr":
        return (
            lambda params, calib: quantize_difvdsr_params(params, calib, n_blocks=module.n_blocks),
            lambda qp, x: apply_difvdsr_int8(qp, x, n_blocks=module.n_blocks),
            None,
            None,
        )
    return None


def _amax_c(t: torch.Tensor) -> torch.Tensor:
    """Per-channel scale max(abs-max, 1e-6) / 127.0, divided by a tensor (on
    CUDA a division by a Python scalar multiplies by its reciprocal)."""
    m = torch.clamp_min(t.abs().amax(dim=tuple(range(t.dim() - 1))), 1e-6)
    return m / torch.full_like(m, 127.0)


def _qfold(p: dict, s_in: torch.Tensor) -> dict:
    """The conv with the input-channel scales folded in: {"qf", "sf", "bias"}."""
    qf, sf = quantize_weights_per_channel(p["kernel"].to(_F32) * s_in[None, None, :, None])
    return {"qf": qf, "sf": sf, "bias": p["bias"].to(_F32)}


def _relu_or_leaky(leaky: float | None):
    """X4's ``act`` for a block's activation: relu, or the leaky slope."""
    return "relu" if leaky is None else float(leaky)


# -- LightBlock chains (difv4) ------------------------------------------------

def _calib_light(h: torch.Tensor, p: dict, leaky: float | None):
    """float32 replay of one LightBlock: (out, scales)."""
    t = _act(_conv(h, p["conv_a"]), _relu_or_leaky(leaky))
    sc = {"x": _amax_c(h), "t": _amax_c(t)}
    return h + 0.1 * _conv(t, p["conv_b"]), sc


def _quantize_light(p: dict, sc: dict) -> dict:
    return {"conv_a": _qfold(p["conv_a"], sc["x"]), "conv_b": _qfold(p["conv_b"], sc["t"]), "actc": sc}


def _codes(x: torch.Tensor, p: dict, s_in, s_out: torch.Tensor, act=None) -> torch.Tensor:
    """The int8 codes at ``s_out`` of act(dequant(int8 conv)) on X4, from x
    quantized at ``s_in`` or from int8 codes (``s_in`` None)."""
    return int8_conv3_codes(x, p["qf"], p["sf"], p["bias"], s_in, s_out, acc=_int8_acc(), act=act)


def _light_i8(x: torch.Tensor, p: dict, leaky: float | None) -> torch.Tensor:
    """JAX's ``(x + 0.1 * u).astype(x.dtype)``, t = act(conv_a(q(x))), u = conv_b(q(t))."""
    b = p["conv_b"]
    tq = _codes(x, p["conv_a"], p["actc"]["x"], p["actc"]["t"], _relu_or_leaky(leaky))
    return int8_conv3_light(tq, b["qf"], b["sf"], b["bias"], x, acc=_int8_acc())


# -- difv4 ----------------------------------------------------------------------

@torch.no_grad()
def quantize_difv4_params(params: Any, calib_x: torch.Tensor, n_head: int = 6, n_mid: int = 20,
                          n_tail: int = 6, scale: int = 4) -> dict:
    """Calibrate on ``calib_x`` ((N, H, W, 3) in [0, 1]) and quantize Difvdsr4
    (``scale=2``: the single-2x variant, no second upsample)."""
    out = {"level1": params["level1"], "out": params["out"]}
    h = torch.relu(_conv(calib_x.to(_F32), params["level1"]))
    for i in range(n_head):
        h, sc = _calib_light(h, params[f"head_{i}"], _DIFV4_LEAKY_HEAD)
        out[f"head_{i}"] = _quantize_light(params[f"head_{i}"], sc)
    h = upsample_phase_tf1(h, 2)
    skip = h
    for i in range(n_mid):
        h, sc = _calib_light(h, params[f"mid_{i}"], None)
        out[f"mid_{i}"] = _quantize_light(params[f"mid_{i}"], sc)
    h = h + skip
    if scale == 4:
        h = upsample_phase_tf1(h, 2)
    for i in range(n_tail):
        h, sc = _calib_light(h, params[f"tail_{i}"], None)
        out[f"tail_{i}"] = _quantize_light(params[f"tail_{i}"], sc)
    return out


def apply_difv4_int8_body(qp: Any, x: torch.Tensor, n_head: int = 6, n_mid: int = 20) -> torch.Tensor:
    """Difvdsr4.body on int8: bf16 level1 + relu, the head at 1x, x2, the mid tower + long skip."""
    h = torch.relu(_conv(x.to(torch.bfloat16), qp["level1"]))
    with span(SPAN_BLOCK):
        for i in range(n_head):
            h = _light_i8(h, qp[f"head_{i}"], _DIFV4_LEAKY_HEAD)
    with span(SPAN_UPSAMPLE):
        h = upsample_phase_tf1(h, 2)
    skip = h
    with span(SPAN_BLOCK):
        for i in range(n_mid):
            h = _light_i8(h, qp[f"mid_{i}"], None)
    return h + skip


def apply_difv4_int8_tail(qp: Any, h: torch.Tensor, n_tail: int = 6, scale: int = 4) -> torch.Tensor:
    """Difvdsr4.tail_fn on int8: (x2 at scale=4), the tail tower, bf16 out conv + relu -> float32."""
    h = h.to(torch.bfloat16)
    if scale == 4:
        with span(SPAN_UPSAMPLE):
            h = upsample_phase_tf1(h, 2)
    with span(SPAN_BLOCK):
        for i in range(n_tail):
            h = _light_i8(h, qp[f"tail_{i}"], None)
    return torch.relu(_conv(h, qp["out"])).to(_F32)


def apply_difv4_int8(qp: Any, x: torch.Tensor, n_head: int = 6, n_mid: int = 20, n_tail: int = 6,
                     scale: int = 4) -> torch.Tensor:
    h = apply_difv4_int8_body(qp, x, n_head=n_head, n_mid=n_mid)
    return apply_difv4_int8_tail(qp, h, n_tail=n_tail, scale=scale)


# -- difvdsr --------------------------------------------------------------------

@torch.no_grad()
def quantize_difvdsr_params(params: Any, calib_x: torch.Tensor, n_blocks: int = 32) -> dict:
    """Calibrate on ``calib_x`` and quantize Difvdsr; a DiffBlock's quantization
    points: its input x, t1 = relu(conv_a(x)), d = conv_b(t1) - x, u1 = lrelu(conv_c(d))."""
    out = {"level1": params["level1"], "out": params["out"]}
    h = torch.relu(_conv(calib_x.to(_F32), params["level1"]))
    for i in range(n_blocks):
        p = params[f"diff_{i}"]
        t1 = torch.relu(_conv(h, p["conv_a"]))
        t = _conv(t1, p["conv_b"])
        d = t - h
        u1 = _act(_conv(d, p["conv_c"]), _DSR_LEAKY)
        u = _conv(u1, p["conv_d"])
        sc = {"x": _amax_c(h), "t1": _amax_c(t1), "d": _amax_c(d), "u1": _amax_c(u1)}
        out[f"diff_{i}"] = {
            "conv_a": _qfold(p["conv_a"], sc["x"]),
            "conv_b": _qfold(p["conv_b"], sc["t1"]),
            "conv_c": _qfold(p["conv_c"], sc["d"]),
            "conv_d": _qfold(p["conv_d"], sc["u1"]),
            "actc": sc,
        }
        h = h + 0.1 * (d + u + t)
    return out


def _diff_i8(x: torch.Tensor, p: dict) -> torch.Tensor:
    """JAX's ``(x + 0.1 * (d + u + t)).astype(x.dtype)``: t1 = relu(conv_a(q(x))),
    t = conv_b(q(t1)), d = t - x, u1 = leaky(conv_c(q(d))), u = conv_d(q(u1))."""
    sc, b, d = p["actc"], p["conv_b"], p["conv_d"]
    t1q = _codes(x, p["conv_a"], sc["x"], sc["t1"], "relu")
    t, dq = int8_conv3_diff_b(t1q, b["qf"], b["sf"], b["bias"], x, sc["d"], acc=_int8_acc())
    u1q = _codes(dq, p["conv_c"], None, sc["u1"], _DSR_LEAKY)
    return int8_conv3_diff_d(u1q, d["qf"], d["sf"], d["bias"], x, t, acc=_int8_acc())


def apply_difvdsr_int8(qp: Any, x: torch.Tensor, n_blocks: int = 32) -> torch.Tensor:
    """(N, H, W, 3) pre-upscaled [0,1] -> the same size: bf16 level1 + relu,
    the DiffBlocks on int8 with bf16 between them, bf16 out conv + relu -> float32."""
    h = torch.relu(_conv(x.to(torch.bfloat16), qp["level1"]))
    for i in range(n_blocks):
        h = _diff_i8(h, qp[f"diff_{i}"])
    return torch.relu(_conv(h, qp["out"])).to(_F32)
