"""Plain reference of difv4, the reference's ``Difvdsr4``
(github.com/diacaf/image-enhance-keras, models.py:992-1142).

  x (N, H, W, 3) in [0, 1] -> 1x1 conv, relu (level1) -> n_head Light blocks
  (leaky relu 0.001) -> TF1 bilinear x2 -> n_mid Light blocks around a long
  skip -> TF1 bilinear x2 -> n_tail Light blocks -> 3x3 conv to 3
  channels, relu (out)

Light: x + 0.1 conv3(act(conv3(x))).  Two forwards, as the program serves
them: ``float32`` (every conv with its bias, TF32 off) and ``int8`` (the
serving profile): level1 and out as bf16 convs with a bf16 bias, every
block conv an int8 convolution over per-channel codes with the
input-channel scales folded into the weights, calibrated (float32 abs-max /
qmax at each block input and post-activation intermediate) on the
calibration input, the block's activation applied before its codes are
taken, bf16 between blocks, the skip and both x2 in bf16.  Rounds op by op
as the program's plain versions do.  Imports nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import Numerics, acc, act, c32, conv_nhwc, quant_c, quantize_weights, upsample_tf1

__all__ = ["param_shapes", "prepare"]

_F32, _BF16 = torch.float32, torch.bfloat16
#: the head tower's leaky relu slope
HEAD_LEAKY = 0.001


def _towers(cfg: dict) -> list[tuple[str, float | None]]:
    m = cfg["model_kwargs"]
    return ([(f"head_{i}", HEAD_LEAKY) for i in range(m["n_head"])]
            + [(f"mid_{i}", None) for i in range(m["n_mid"])]
            + [(f"tail_{i}", None) for i in range(m["n_tail"])])


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    c = cfg["model_kwargs"]["features"]
    shapes = {"level1/kernel": (1, 1, 3, c), "level1/bias": (c,)}
    for name, _ in _towers(cfg):
        for conv in ("conv_a", "conv_b"):
            shapes[f"{name}/{conv}/kernel"] = (3, 3, c, c)
            shapes[f"{name}/{conv}/bias"] = (c,)
    shapes.update({"out/kernel": (3, 3, c, 3), "out/bias": (3,)})
    return shapes


def _walk(cfg: dict, h: torch.Tensor, block, up2):
    """The graph from the level1 output on: ``block(h, name, slope)`` for
    every Light block, ``up2`` for both x2, the long skip around the mid tower."""
    m = cfg["model_kwargs"]
    for i in range(m["n_head"]):
        h = block(h, f"head_{i}", HEAD_LEAKY)
    h = up2(h)
    skip = h
    for i in range(m["n_mid"]):
        h = block(h, f"mid_{i}", None)
    h = up2(h + skip)
    for i in range(m["n_tail"]):
        h = block(h, f"tail_{i}", None)
    return h


def _forward_f32(params: dict, cfg: dict, num: Numerics):
    def conv(x, p):
        return conv_nhwc(x, p["kernel"], p["bias"], num=num)

    def block(h, name, slope):
        p = params[name]
        return h + 0.1 * conv(act(conv(h, p["conv_a"]), slope), p["conv_b"])

    def forward(x):
        h = torch.relu(conv(x.to(_F32), params["level1"]))
        h = _walk(cfg, h, block, lambda t: upsample_tf1(t, 2))
        return torch.relu(conv(h, params["out"]))

    return forward


def _conv(x, p, num):
    return conv_nhwc(x, p["kernel"].to(x.dtype), num=num) + p["bias"].to(x.dtype)


def _quantize(params: dict, cfg: dict, calib_x: torch.Tensor, num: Numerics) -> dict:
    """Calibrate on ``calib_x`` (float32 graph, scales abs-max / qmax, at least
    1e-6 / qmax) and fold the scales into per-output-channel weight codes."""

    def amax_c(t):
        m = torch.clamp_min(t.abs().amax(dim=(0, 1, 2)), 1e-6)
        return m / torch.full_like(m, float(num.qmax))

    def fold(p, s_in):
        q, s = quantize_weights(p["kernel"].to(_F32) * s_in[None, None, :, None], num)
        return {"q": q, "s": s, "bias": p["bias"].to(_F32)}

    qp = {"level1": params["level1"], "out": params["out"]}

    def block(h, name, slope):
        p = params[name]
        t = act(_conv(h, p["conv_a"], num), slope)
        sx, st = amax_c(h), amax_c(t)
        qp[name] = {"conv_a": fold(p["conv_a"], sx), "conv_b": fold(p["conv_b"], st), "x": sx, "t": st}
        return h + 0.1 * _conv(t, p["conv_b"], num)

    h = torch.relu(_conv(calib_x.to(_F32), params["level1"], num))
    _walk(cfg, h, block, lambda t: upsample_tf1(t, 2))
    return qp


def _forward_int8(qp: dict, cfg: dict, num: Numerics):
    def block(x, name, slope):
        p = qp[name]
        a, b = p["conv_a"], p["conv_b"]
        t = act(acc(quant_c(x, p["x"], num), a["q"]) * a["s"] + a["bias"], slope)
        u = acc(quant_c(t, p["t"], num), b["q"]) * b["s"] + b["bias"]
        return (x.to(_F32) + c32(0.1) * u).to(x.dtype)

    def forward(x):
        h = torch.relu(_conv(x.to(_BF16), qp["level1"], num))
        h = _walk(cfg, h, block, lambda t: upsample_tf1(t.to(_BF16), 2))
        return torch.relu(_conv(h, qp["out"], num)).to(_F32)

    return forward


def prepare(params: dict, cfg: dict, forward: str, calib_x: torch.Tensor | None, num: Numerics):
    """The reference forward of the program's ``forward``, its set-up done here."""
    if forward == "xla":
        return _forward_f32(params, cfg, num)
    if forward == "int8":
        return _forward_int8(_quantize(params, cfg, calib_x, num), cfg, num)
    raise ValueError(f"no difv4 reference for forward={forward!r}")
