"""Plain reference of didbl, the reference's ``DifvdsrDouble``
(github.com/diacaf/image-enhance-keras, models.py:1146-1270).

  x (N, H, W, 3) in [0, 1] -> 1x1 conv, relu (level1) -> n_body53 Light53
  blocks -> n_light Light blocks -> TF1 bilinear x scale -> n_tail53 Light53
  blocks -> 3x3 conv to 3 channels, relu (out)

Light53: 0.9 x + 0.1 (conv5(relu(conv3(x))) + conv3(relu(conv5(x))));
Light: x + 0.1 conv3(relu(conv3(x))).  Two forwards, as the program serves
them:

* ``float32``: every conv in float32 with its bias, TF32 off;
* ``int8`` (the serving profile): level1 and out as bf16 convs with a bf16
  bias; every block conv an int8 convolution over per-channel codes, the
  input-channel scales folded into the weights, calibrated (float32
  abs-max / qmax at each block input and each branch's post-relu
  intermediate) on the calibration input; bf16 between blocks; the x4 in
  bf16.  The block arithmetic rounds op by op as the program's plain
  versions do (the accumulator's exact sum to float32, then bf16).

Imports nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import Numerics, acc, c32, conv_nhwc, quant_c, quantize_weights, upsample_tf1

__all__ = ["param_shapes", "prepare"]

_F32, _BF16 = torch.float32, torch.bfloat16
_L53 = (("conv_a1", 3), ("conv_a2", 5), ("conv_b1", 5), ("conv_b2", 3))
_LIGHT = (("conv_a", 3), ("conv_b", 3))


def _blocks(cfg: dict) -> list[tuple[str, tuple]]:
    m = cfg["model_kwargs"]
    return ([(f"body53_{i}", _L53) for i in range(m["n_body53"])]
            + [(f"light_{i}", _LIGHT) for i in range(m["n_light"])]
            + [(f"tail53_{i}", _L53) for i in range(m["n_tail53"])])


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Parameter name ("level1/kernel", "body53_0/conv_a1/bias", ...) -> shape, HWIO kernels."""
    c = cfg["model_kwargs"]["features"]
    shapes = {"level1/kernel": (1, 1, 3, c), "level1/bias": (c,)}
    for name, convs in _blocks(cfg):
        for conv, k in convs:
            shapes[f"{name}/{conv}/kernel"] = (k, k, c, c)
            shapes[f"{name}/{conv}/bias"] = (c,)
    shapes.update({"out/kernel": (3, 3, c, 3), "out/bias": (3,)})
    return shapes


def _conv(x, p, num):
    """conv in x's dtype, the kernel and the bias cast to it, the bias added after."""
    return conv_nhwc(x, p["kernel"].to(x.dtype), num=num) + p["bias"].to(x.dtype)


# -- float32 --------------------------------------------------------------------

def _forward_f32(params: dict, cfg: dict, num: Numerics):
    m = cfg["model_kwargs"]

    def conv(x, p):
        return conv_nhwc(x, p["kernel"], p["bias"], num=num)

    def l53(x, p):
        a = conv(torch.relu(conv(x, p["conv_a1"])), p["conv_a2"])
        b = conv(torch.relu(conv(x, p["conv_b1"])), p["conv_b2"])
        return 0.9 * x + 0.1 * (a + b)

    def forward(x):
        h = torch.relu(conv(x.to(_F32), params["level1"]))
        for i in range(m["n_body53"]):
            h = l53(h, params[f"body53_{i}"])
        for i in range(m["n_light"]):
            p = params[f"light_{i}"]
            h = h + 0.1 * conv(torch.relu(conv(h, p["conv_a"])), p["conv_b"])
        h = upsample_tf1(h, m["scale"])
        for i in range(m["n_tail53"]):
            h = l53(h, params[f"tail53_{i}"])
        return torch.relu(conv(h, params["out"]))

    return forward


# -- int8 -----------------------------------------------------------------------

def _calibrate(params: dict, cfg: dict, calib_x: torch.Tensor, num: Numerics) -> dict:
    """Per-channel activation scales max(abs-max, 1e-6) * (1/qmax) of the
    float32 graph run on ``calib_x``: x, a, b of each Light53 block, x, t of each Light block."""
    m = cfg["model_kwargs"]
    scales: dict = {}

    def amax(t):
        return torch.clamp_min(t.abs().amax(dim=(0, 1, 2)), 1e-6) * (1.0 / float(num.qmax))

    def l53(h, p, name):
        a = torch.relu(_conv(h, p["conv_a1"], num))
        b = torch.relu(_conv(h, p["conv_b1"], num))
        scales[name] = {"x": amax(h), "a": amax(a), "b": amax(b)}
        return 0.9 * h + 0.1 * (_conv(a, p["conv_a2"], num) + _conv(b, p["conv_b2"], num))

    h = torch.relu(_conv(calib_x.to(_F32), params["level1"], num))
    for i in range(m["n_body53"]):
        h = l53(h, params[f"body53_{i}"], f"body53_{i}")
    for i in range(m["n_light"]):
        p = params[f"light_{i}"]
        t = torch.relu(_conv(h, p["conv_a"], num))
        scales[f"light_{i}"] = {"x": amax(h), "t": amax(t)}
        h = h + 0.1 * _conv(t, p["conv_b"], num)
    h = upsample_tf1(h, m["scale"])
    for i in range(m["n_tail53"]):
        h = l53(h, params[f"tail53_{i}"], f"tail53_{i}")
    return scales


def _fold(p: dict, s_in: torch.Tensor, num: Numerics) -> dict:
    """The conv's weights with its input-channel scales folded in, quantized per output channel."""
    q, s = quantize_weights(p["kernel"].to(_F32) * s_in[None, None, :, None], num)
    return {"q": q, "s": s, "bias": p["bias"].to(_F32)}


def _quantize(params: dict, cfg: dict, calib_x: torch.Tensor, num: Numerics) -> dict:
    sc = _calibrate(params, cfg, calib_x, num)
    qp = {"level1": params["level1"], "out": params["out"]}
    for name, convs in _blocks(cfg):
        s_in = ({"conv_a1": "x", "conv_b1": "x", "conv_a2": "a", "conv_b2": "b"} if len(convs) == 4
                else {"conv_a": "x", "conv_b": "t"})
        qp[name] = {conv: _fold(params[name][conv], sc[name][s_in[conv]], num) for conv, _ in convs}
        qp[name]["act"] = sc[name]
    return qp


def _light53_i8(x, p, num):
    xf = x.to(_F32)
    s = p["act"]
    xq = quant_c(xf, s["x"], num)
    a1 = acc(xq, p["conv_a1"]["q"]) * p["conv_a1"]["s"] + p["conv_a1"]["bias"]
    b1 = acc(xq, p["conv_b1"]["q"]) * p["conv_b1"]["s"] + p["conv_b1"]["bias"]
    aq = quant_c(torch.relu(a1), s["a"], num)
    bq = quant_c(torch.relu(b1), s["b"], num)
    a = acc(aq, p["conv_a2"]["q"]) * p["conv_a2"]["s"] + p["conv_a2"]["bias"]
    b = acc(bq, p["conv_b2"]["q"]) * p["conv_b2"]["s"] + p["conv_b2"]["bias"]
    return (c32(0.9) * xf + c32(0.1) * (a + b)).to(x.dtype)


def _light_i8(x, p, num):
    xf = x.to(_F32)
    s = p["act"]
    t = acc(quant_c(xf, s["x"], num), p["conv_a"]["q"]) * p["conv_a"]["s"] + p["conv_a"]["bias"]
    tq = quant_c(torch.relu(t), s["t"], num)
    u = acc(tq, p["conv_b"]["q"]) * p["conv_b"]["s"] + p["conv_b"]["bias"]
    return (xf + c32(0.1) * u).to(x.dtype)


def _forward_int8(qp: dict, cfg: dict, num: Numerics):
    m = cfg["model_kwargs"]

    def forward(x):
        h = torch.relu(_conv(x.to(_BF16), qp["level1"], num))
        for i in range(m["n_body53"]):
            h = _light53_i8(h, qp[f"body53_{i}"], num)
        for i in range(m["n_light"]):
            h = _light_i8(h, qp[f"light_{i}"], num)
        h = upsample_tf1(h.to(_BF16), m["scale"])
        for i in range(m["n_tail53"]):
            h = _light53_i8(h, qp[f"tail53_{i}"], num)
        return torch.relu(_conv(h, qp["out"], num)).to(_F32)

    return forward


def prepare(params: dict, cfg: dict, forward: str, calib_x: torch.Tensor | None, num: Numerics):
    """The reference forward ((N, h, w, 3) in [0, 1] -> (N, s h, s w, 3) float32)
    of the program's ``forward``, its set-up (calibration, quantization) done here."""
    if forward == "xla":
        return _forward_f32(params, cfg, num)
    if forward == "int8":
        return _forward_int8(_quantize(params, cfg, calib_x, num), cfg, num)
    raise ValueError(f"no didbl reference for forward={forward!r}")
