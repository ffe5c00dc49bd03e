"""Kernel forwards of the didbl generator (mirror of ``models/didbl_pallas.py``).

``apply_didbl_pallas`` runs the DifvdsrDouble graph over the same parameter
tree with the 16 Light53 and 6 Light LR blocks on the CUDA kernels of
``ops/cuda/blocks.py``, or with ``chain=True`` (``--forward pallas_chain``)
on the two chain kernels of ``ops/cuda/tower.py``.  The 1x1 ``level1``
conv, the TF1 x4 (as two dense contractions), the two HR Light53 blocks and
the 3x3 ``out`` conv are plain torch, as the JAX version leaves them to XLA.
``dtype=torch.bfloat16`` runs it all in bf16 as JAX does: the input cast,
the kernels' bf16 forms, the plain convs in bf16 with the weights cast at
use, and a float32 output.

The int8 path: ``quantize_didbl_params`` turns the tree into int8 weights
with per-channel scales and, given a calibration input, static activation
scales from ``calibrate_didbl_act_scales`` (the serving path, ``--forward
pallas_int8``, which always calibrates); ``apply_didbl_int8`` then runs
every residual block, the two HR tail blocks included, on the int8 kernels
of ``ops/cuda/int8_blocks.py``, with bf16 activations between blocks and
the x4 through ``ops.resize.upsample_phase_tf1``.  A tree quantized without
``calib_x`` has no "act" entries, and the blocks then quantize every window
of ``tile`` with its own dynamic abs-max scales, as in JAX (the library's
uncalibrated path; no CLI flag reaches it).

The XLA int8 path (``--forward int8``, the production serving profile of the
JAX package): ``apply_didbl_int8_xla`` runs every residual block on the
per-channel int8 kernels of ``ops/cuda/int8_xla.py`` over the folded
"qf"/"sf" copies (the HR tail, with ``dynamic=True``, on per-sample
dynamic scales over "q"/"s"), bf16 activations between blocks.  The env
knobs are read at call time, as JAX reads them at trace time:
``IEK_INT8_ACC`` (bf16 | s32 | f32, the conv accumulator),
``IEK_INT8_EMIT`` (wide | s8, bit-equal), and the research knobs, each on
when set to 1: ``IEK_INT8_MERGE55`` (each Light53 block's two first convs
as one 5x5 conv with 2C outputs in the plain versions; exact, so the same
bytes; the kernels already stage x once for both), ``IEK_INT8_UPQ`` (static
tail with at least one block: the x4 fused with the first HR block's
quantize, K3q, and that block on X1u, which forms its float32 skip
``x4(0.9 * h)`` from the LR map) and ``IEK_INT8_UPMM`` (the x4 as ``resize_bilinear_tf1``, two
dense contractions; K3 does not run).

On CPU tensors the kernel wrappers run their plain versions.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from image_enhance_keras_tpu_torch.models.blocks import profile_dtype, scale as _scale
from image_enhance_keras_tpu_torch.ops.conv import conv2d_nhwc
from image_enhance_keras_tpu_torch.ops.cuda.blocks import fused_light53_block, fused_light_block
from image_enhance_keras_tpu_torch.ops.cuda.int8_blocks import (
    light53_int8,
    light_int8,
    quantize_weights_per_channel,
)
from image_enhance_keras_tpu_torch.ops.cuda.int8_conv import int8_conv3, int8_conv3_dyn
from image_enhance_keras_tpu_torch.ops.cuda.int8_xla import (
    light53_int8_xla,
    light53_int8_xla_dyn,
    light53_int8_xla_upq,
    light_int8_xla,
)
from image_enhance_keras_tpu_torch.ops.cuda.upsample import upsample_quant_tf1
from image_enhance_keras_tpu_torch.ops.cuda.tower import fused_light53_chain, fused_light_chain
from image_enhance_keras_tpu_torch.ops.pixel_shuffle import depth_to_space
from image_enhance_keras_tpu_torch.ops.resize import resize_bilinear_tf1, upsample_phase_tf1
from image_enhance_keras_tpu_torch.utils.logging import get_logger
from image_enhance_keras_tpu_torch.utils.profiling import SPAN_BLOCK, SPAN_UPSAMPLE, span

log = get_logger(__name__)

__all__ = [
    "apply_didbl_pallas",
    "calibrate_didbl_act_scales",
    "quantize_didbl_params",
    "apply_didbl_int8",
    "apply_didbl_int8_body",
    "apply_didbl_int8_tail",
    "apply_didbl_int8_xla",
    "apply_didbl_int8_xla_body",
    "apply_didbl_int8_xla_body_tiled",
    "apply_didbl_int8_xla_tail",
]


def _conv(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SAME conv in x's dtype (kernel and bias cast to it) plus bias."""
    return conv2d_nhwc(x, p["kernel"].to(x.dtype)) + p["bias"].to(x.dtype)


def _light53(x: torch.Tensor, p: dict) -> torch.Tensor:
    return fused_light53_block(
        x,
        p["conv_a1"]["kernel"], p["conv_a1"]["bias"],
        p["conv_a2"]["kernel"], p["conv_a2"]["bias"],
        p["conv_b1"]["kernel"], p["conv_b1"]["bias"],
        p["conv_b2"]["kernel"], p["conv_b2"]["bias"],
        res_scale=0.1,
        identity_scale=0.9,
    )


def _light53_xla(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Plain light53 for the post-upsample blocks, in x's dtype (bf16 scales for bf16)."""
    a = _conv(torch.relu(_conv(x, p["conv_a1"])), p["conv_a2"])
    b = _conv(torch.relu(_conv(x, p["conv_b1"])), p["conv_b2"])
    return _scale(0.9, x) * x + _scale(0.1, x) * (a + b)


def _stacked(blocks: list, convs: tuple) -> list:
    """[kernel, bias] of each conv, stacked over the blocks on a leading K axis.

    Cached on the first block's first kernel, keyed by the identity and
    version of every tensor stacked, so that a loaded tree is stacked (and
    its chain weights packed by the kernels' wrappers) once.  The stacks stay
    float32 for both profiles; each carries its float32 (3xTF32) and bf16
    packs apart, under one attribute per policy (``tf32x3.cached_pack``).
    """
    parts = [[b[c][k] for b in blocks] for c in convs for k in ("kernel", "bias")]
    flat = [t for ts in parts for t in ts]
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
        return [torch.stack(ts) for ts in parts]
    versions = [None if t.is_inference() else t._version for t in flat]
    holder = parts[0][0]
    cached = getattr(holder, "_iek_stacked", None)
    if (cached is not None and len(cached[0]) == len(flat)
            and all(a is b for a, b in zip(cached[0], flat)) and cached[1] == versions):
        return cached[2]
    stacked = [torch.stack(ts) for ts in parts]
    holder._iek_stacked = (flat, versions, stacked)
    return stacked


def apply_didbl_pallas(params: Any, x: torch.Tensor, dtype: Any = None, n_body53: int = 16,
                       n_light: int = 6, n_tail53: int = 2, scale: int = 4,
                       chain: bool = False) -> torch.Tensor:
    """(N, H, W, 3) [0,1] -> (N, 4H, 4W, 3) float32; same math as DifvdsrDouble.

    ``chain=True`` runs the 16 Light53 and the 6 Light blocks as one chain
    kernel each (``ops/cuda/tower.py``), over weights stacked on a K axis.
    ``dtype`` (None / float32, or bfloat16) is the activations' dtype; the
    x4 is the two dense contractions in it, as in JAX, not the phase
    upsample of the module forward."""
    h = torch.relu(_conv(x.to(profile_dtype(dtype)), params["level1"]))
    if chain:
        b53 = [params[f"body53_{i}"] for i in range(n_body53)]
        h = fused_light53_chain(h, *_stacked(b53, ("conv_a1", "conv_a2", "conv_b1", "conv_b2")),
                                res_scale=0.1, identity_scale=0.9)
        bl = [params[f"light_{i}"] for i in range(n_light)]
        h = fused_light_chain(h, *_stacked(bl, ("conv_a", "conv_b")), res_scale=0.1)
    else:
        for i in range(n_body53):
            h = _light53(h, params[f"body53_{i}"])
        for i in range(n_light):
            p = params[f"light_{i}"]
            h = fused_light_block(
                h,
                p["conv_a"]["kernel"], p["conv_a"]["bias"],
                p["conv_b"]["kernel"], p["conv_b"]["bias"],
                res_scale=0.1,
            )
    h = resize_bilinear_tf1(h, (scale * h.shape[-3], scale * h.shape[-2]))
    for i in range(n_tail53):
        h = _light53_xla(h, params[f"tail53_{i}"])
    return torch.relu(_conv(h, params["out"])).to(torch.float32)


# ---------------------------------------------------------------------------
# int8 serving path (ops/cuda/int8_blocks.py)
# ---------------------------------------------------------------------------

def calibrate_didbl_act_scales(params: Any, x: torch.Tensor, n_body53: int = 16, n_light: int = 6,
                               n_tail53: int = 2, scale: int = 4,
                               per_channel: bool = False, upsampler: str = "tf1_bilinear") -> dict:
    """Activation scales for the int8 path: float32 abs-max / 127 at every
    quantization point (each block's input and each branch's post-relu
    intermediate) of the didbl graph run on ``x``.  Returns
    {block_name: {"x": s, "a": s, "b": s}} for Light53 blocks and
    {"x": s, "t": s} for Light blocks (and {"x": s} for the subpixel head's
    conv, ``upsampler="subpixel"``); ``per_channel`` gives (C,) vectors."""
    scales: dict = {}

    def amax(t):
        m = t.abs().amax(dim=tuple(range(t.dim() - 1))) if per_channel else t.abs().amax()
        return torch.clamp_min(m, 1e-6) * (1.0 / 127.0)

    def l53(h, p, name):
        a = torch.relu(_conv(h, p["conv_a1"]))
        b = torch.relu(_conv(h, p["conv_b1"]))
        scales[name] = {"x": amax(h), "a": amax(a), "b": amax(b)}
        a = _conv(a, p["conv_a2"])
        b = _conv(b, p["conv_b2"])
        return 0.9 * h + 0.1 * (a + b)

    def light(h, p, name):
        t = torch.relu(_conv(h, p["conv_a"]))
        scales[name] = {"x": amax(h), "t": amax(t)}
        return h + 0.1 * _conv(t, p["conv_b"])

    h = torch.relu(_conv(x.to(torch.float32), params["level1"]))
    for i in range(n_body53):
        h = l53(h, params[f"body53_{i}"], f"body53_{i}")
    for i in range(n_light):
        h = light(h, params[f"light_{i}"], f"light_{i}")
    if upsampler == "subpixel":
        scales["subpixel_conv"] = {"x": amax(h)}
        h = depth_to_space(_conv(h, params["subpixel_conv"]), scale, order="dcr")
    else:
        h = upsample_phase_tf1(h, scale)
    for i in range(n_tail53):
        h = l53(h, params[f"tail53_{i}"], f"tail53_{i}")
    return scales


def quantize_didbl_params(params: Any, n_body53: int = 16, n_light: int = 6, n_tail53: int = 2,
                          calib_x: torch.Tensor | None = None, scale: int = 4,
                          upsampler: str = "tf1_bilinear") -> dict:
    """One-time weight quantization: every residual-block conv becomes
    {"q": int8 HWIO, "s": (Cout,) scale, "bias"}; level1/out stay float.

    Without ``calib_x`` no block has activation scales, and
    ``apply_didbl_int8`` quantizes each window dynamically.  With
    ``calib_x`` ((N, H, W, 3) in [0, 1]) each block also gets "act"
    (stacked per-tensor scales, what the kernels take), "actc" (per-channel
    scale vectors) and, per conv, "qf"/"sf": the weights with the input
    channel scales folded in (conv(x, w) = conv(x / s_c, w * s_c)), which the
    XLA-style int8 path of the JAX package consumes.  ``upsampler="subpixel"``
    quantizes the head's ``subpixel_conv`` the same way."""

    def qconv(p):
        q, s = quantize_weights_per_channel(p["kernel"])
        return {"q": q, "s": s, "bias": p["bias"].to(torch.float32)}

    def fold(entry, p, s_in):
        entry["qf"], entry["sf"] = quantize_weights_per_channel(
            p["kernel"].to(torch.float32) * s_in[None, None, :, None])

    actc = (
        calibrate_didbl_act_scales(params, calib_x, n_body53=n_body53, n_light=n_light,
                                   n_tail53=n_tail53, scale=scale, per_channel=True,
                                   upsampler=upsampler)
        if calib_x is not None
        else {}
    )
    out = {"level1": params["level1"], "out": params["out"]}
    if upsampler == "subpixel":
        blk = params["subpixel_conv"]
        out["subpixel_conv"] = qconv(blk)
        if "subpixel_conv" in actc:
            out["subpixel_conv"]["actc"] = actc["subpixel_conv"]
            fold(out["subpixel_conv"], blk, actc["subpixel_conv"]["x"])
    for prefix, n in (("body53", n_body53), ("tail53", n_tail53)):
        for i in range(n):
            name = f"{prefix}_{i}"
            blk = params[name]
            out[name] = {k: qconv(blk[k]) for k in ("conv_a1", "conv_a2", "conv_b1", "conv_b2")}
            if name in actc:
                sc = actc[name]
                out[name]["actc"] = sc
                out[name]["act"] = torch.stack([sc["x"].max(), sc["a"].max(), sc["b"].max()])
                fold(out[name]["conv_a1"], blk["conv_a1"], sc["x"])
                fold(out[name]["conv_a2"], blk["conv_a2"], sc["a"])
                fold(out[name]["conv_b1"], blk["conv_b1"], sc["x"])
                fold(out[name]["conv_b2"], blk["conv_b2"], sc["b"])
    for i in range(n_light):
        name = f"light_{i}"
        blk = params[name]
        out[name] = {k: qconv(blk[k]) for k in ("conv_a", "conv_b")}
        if name in actc:
            sc = actc[name]
            out[name]["actc"] = sc
            out[name]["act"] = torch.stack([sc["x"].max(), sc["t"].max()])
            fold(out[name]["conv_a"], blk["conv_a"], sc["x"])
            fold(out[name]["conv_b"], blk["conv_b"], sc["t"])
    return out


def _light53_i8(x: torch.Tensor, p: dict, tile: tuple[int, int]) -> torch.Tensor:
    return light53_int8(
        x,
        p["conv_a1"]["q"], p["conv_a1"]["s"], p["conv_a1"]["bias"],
        p["conv_a2"]["q"], p["conv_a2"]["s"], p["conv_a2"]["bias"],
        p["conv_b1"]["q"], p["conv_b1"]["s"], p["conv_b1"]["bias"],
        p["conv_b2"]["q"], p["conv_b2"]["s"], p["conv_b2"]["bias"],
        res_scale=0.1, identity_scale=0.9, tile=tile, act_scales=p.get("act"),
    )


def apply_didbl_int8_body(qparams: Any, x: torch.Tensor, n_body53: int = 16, n_light: int = 6,
                          tile: tuple[int, int] = (64, 128)) -> torch.Tensor:
    """int8 pre-upsample tower at LR: bf16 level1 + relu, then the int8 blocks."""
    h = torch.relu(_conv(x.to(torch.bfloat16), qparams["level1"]))
    for i in range(n_body53):
        h = _light53_i8(h, qparams[f"body53_{i}"], tile)
    for i in range(n_light):
        p = qparams[f"light_{i}"]
        h = light_int8(
            h,
            p["conv_a"]["q"], p["conv_a"]["s"], p["conv_a"]["bias"],
            p["conv_b"]["q"], p["conv_b"]["s"], p["conv_b"]["bias"],
            res_scale=0.1, tile=tile, act_scales=p.get("act"),
        )
    return h


def apply_didbl_int8_tail(qparams: Any, h: torch.Tensor, n_tail53: int = 2, scale: int = 4,
                          tile: tuple[int, int] = (64, 128)) -> torch.Tensor:
    """bf16 x4 upsample, the int8 HR Light53 blocks, bf16 out conv + relu -> float32."""
    h = upsample_phase_tf1(h.to(torch.bfloat16), scale)
    for i in range(n_tail53):
        h = _light53_i8(h, qparams[f"tail53_{i}"], tile)
    return torch.relu(_conv(h, qparams["out"])).to(torch.float32)


def apply_didbl_int8(qparams: Any, x: torch.Tensor, n_body53: int = 16, n_light: int = 6,
                     n_tail53: int = 2, scale: int = 4,
                     tile: tuple[int, int] = (64, 128)) -> torch.Tensor:
    """(N, H, W, 3) [0,1] -> (N, 4H, 4W, 3): the didbl graph with every
    residual block on the int8 kernels; identity paths carry no quantization
    error, activations are bf16 between blocks.  Blocks with "act" use those
    static scales; blocks without (``quantize_didbl_params`` without
    ``calib_x``) quantize each ``tile`` window dynamically."""
    h = apply_didbl_int8_body(qparams, x, n_body53=n_body53, n_light=n_light, tile=tile)
    return apply_didbl_int8_tail(qparams, h, n_tail53=n_tail53, scale=scale, tile=tile)


# ---------------------------------------------------------------------------
# XLA int8 serving path (--forward int8; ops/cuda/int8_xla.py)
# ---------------------------------------------------------------------------

def _int8_acc() -> str:
    """The conv accumulator, ``IEK_INT8_ACC`` (bf16 | s32 | f32), read at call time."""
    return os.environ.get("IEK_INT8_ACC", "bf16")


def _emit_s8() -> bool:
    """``IEK_INT8_EMIT=s8``: the fused requantization of the branch intermediates."""
    return os.environ.get("IEK_INT8_EMIT", "wide") == "s8"


def _knob(name: str) -> bool:
    """A research knob (``IEK_INT8_MERGE55``, ``IEK_INT8_UPQ``, ``IEK_INT8_UPMM``): on when set to 1."""
    return os.environ.get(name, "0") == "1"


def _light53_i8_xla(x: torch.Tensor, p: dict) -> torch.Tensor:
    sc = p["actc"]
    return light53_int8_xla(
        x,
        p["conv_a1"]["qf"], p["conv_a1"]["sf"], p["conv_a1"]["bias"],
        p["conv_a2"]["qf"], p["conv_a2"]["sf"], p["conv_a2"]["bias"],
        p["conv_b1"]["qf"], p["conv_b1"]["sf"], p["conv_b1"]["bias"],
        p["conv_b2"]["qf"], p["conv_b2"]["sf"], p["conv_b2"]["bias"],
        _stacked_actc(p, ("x", "a", "b")), acc=_int8_acc(), emit_s8=_emit_s8(),
        merge55=_knob("IEK_INT8_MERGE55"),
    )


def _light53_i8_xla_upfused(h_lr: torch.Tensor, p: dict, scale: int) -> torch.Tensor:
    """The first HR Light53 block with the x4 fused into both its consumers
    (``IEK_INT8_UPQ``, JAX's ``_light53_i8_xla_upfused``): the conv input is
    the codes of the bf16 x4 of ``h_lr`` (K3q: the bf16 HR map is never
    written), the identity leg the float32 x4 of 0.9 * h_lr, formed from
    ``h_lr`` inside the block's combine, skip + 0.1 * (a + b) (X1u: no HR
    skip map is written either), bf16 out.  ``h_lr`` is bf16."""
    sc = p["actc"]
    xq = upsample_quant_tf1(h_lr, scale, sc["x"])
    return light53_int8_xla_upq(
        xq, h_lr,
        p["conv_a1"]["qf"], p["conv_a1"]["sf"], p["conv_a1"]["bias"],
        p["conv_a2"]["qf"], p["conv_a2"]["sf"], p["conv_a2"]["bias"],
        p["conv_b1"]["qf"], p["conv_b1"]["sf"], p["conv_b1"]["bias"],
        p["conv_b2"]["qf"], p["conv_b2"]["sf"], p["conv_b2"]["bias"],
        _stacked_actc(p, ("a", "b")), acc=_int8_acc(), emit_s8=_emit_s8(),
    )


def _light_i8_xla(x: torch.Tensor, p: dict) -> torch.Tensor:
    return light_int8_xla(
        x,
        p["conv_a"]["qf"], p["conv_a"]["sf"], p["conv_a"]["bias"],
        p["conv_b"]["qf"], p["conv_b"]["sf"], p["conv_b"]["bias"],
        _stacked_actc(p, ("x", "t")), acc=_int8_acc(), emit_s8=_emit_s8(),
    )


def _light53_i8_xla_dyn(x: torch.Tensor, p: dict) -> torch.Tensor:
    return light53_int8_xla_dyn(
        x,
        p["conv_a1"]["q"], p["conv_a1"]["s"], p["conv_a1"]["bias"],
        p["conv_a2"]["q"], p["conv_a2"]["s"], p["conv_a2"]["bias"],
        p["conv_b1"]["q"], p["conv_b1"]["s"], p["conv_b1"]["bias"],
        p["conv_b2"]["q"], p["conv_b2"]["s"], p["conv_b2"]["bias"],
        acc=_int8_acc(), merge55=_knob("IEK_INT8_MERGE55"),
    )


def _stacked_actc(p: dict, keys: tuple) -> torch.Tensor:
    """The block's per-channel scale vectors as one (k, C) tensor, what the
    kernels take; cached on the first vector, keyed by the identity of all."""
    vecs = [p["actc"][k] for k in keys]
    cached = getattr(vecs[0], "_iek_actc", None)
    if cached is None or len(cached[0]) != len(vecs) or any(a is not b for a, b in zip(cached[0], vecs)):
        cached = (vecs, torch.stack(vecs).contiguous())
        vecs[0]._iek_actc = cached
    return cached[1]


def _require_act(qparams: Any) -> None:
    if "actc" not in qparams.get("body53_0", {}):
        raise ValueError(
            "forward='int8' needs calibrated activation scales: quantize with "
            "quantize_didbl_params(..., calib_x=...)"
        )


def apply_didbl_int8_xla_body(qparams: Any, x: torch.Tensor, n_body53: int = 16,
                              n_light: int = 6) -> torch.Tensor:
    """XLA-int8 pre-upsample tower at LR: bf16 level1 + relu, then the per-channel int8 blocks."""
    _require_act(qparams)
    h = torch.relu(_conv(x.to(torch.bfloat16), qparams["level1"]))
    with span(SPAN_BLOCK):
        for i in range(n_body53):
            h = _light53_i8_xla(h, qparams[f"body53_{i}"])
        for i in range(n_light):
            h = _light_i8_xla(h, qparams[f"light_{i}"])
    return h


def _tiled_chain(h: torch.Tensor, fns: list, radius_per_fn: list, tile: int) -> torch.Tensor:
    """Run a chain of spatially local block functions over shifted spatial tiles.

    ``h`` is (1, H, W, C); the chain's zero-pad pollution reaches
    ``sum(radius_per_fn)`` pixels in, so the tiles carry that halo and only
    their owned cores are stitched back: the same result as the whole-frame
    chain.  Batched or too small inputs run the untiled chain, with a warning.
    """
    from image_enhance_keras_tpu_torch.tiling.tiles import (
        gather_tiles_2d,
        scatter_tiles_2d,
        shift_grid_axis,
        shifted_extract_indices,
        shifted_stitch_indices,
    )

    halo = int(sum(radius_per_fn))
    H, W = int(h.shape[1]), int(h.shape[2])
    if min(H, W) <= tile + 2 * halo or h.shape[0] != 1:
        log.warning(
            "int8 body tiling requested (tile=%d) but input %s is %s; running the untiled chain",
            tile, tuple(h.shape), "batched" if h.shape[0] != 1 else "too small to tile",
        )
        for f in fns:
            h = f(h)
        return h
    T_r, starts_r, _ = shift_grid_axis(H, tile, halo)
    T_c, starts_c, _ = shift_grid_axis(W, tile, halo)
    n_r, n_c = len(starts_r), len(starts_c)

    def dev(a):
        return torch.from_numpy(a).to(h.device)

    t = gather_tiles_2d(h[0], dev(shifted_extract_indices(H, tile, halo)),
                        dev(shifted_extract_indices(W, tile, halo)), n_r, n_c, T_r, T_c)
    for f in fns:
        t = f(t)
    return scatter_tiles_2d(t, dev(shifted_stitch_indices(H, tile, halo, 1)),
                            dev(shifted_stitch_indices(W, tile, halo, 1)), n_r, n_c, T_r, T_c,
                            scale=1)[None].contiguous()


#: receptive-field radii of the blocks: Light53 = max(3x3 then 5x5) = 3; Light = two 3x3 = 2
_LIGHT53_RADIUS = 3
_LIGHT_RADIUS = 2


def apply_didbl_int8_xla_body_tiled(qparams: Any, x: torch.Tensor, n_body53: int = 16,
                                    n_light: int = 6, tile: int = 256, seg: int = 4) -> torch.Tensor:
    """XLA-int8 body with per-segment spatial tiling: the blocks in segments of
    ``seg``, each over shifted (tile + 2*halo)^2 tiles (halo: the segment's
    summed radius), stitched between segments; the same output as
    :func:`apply_didbl_int8_xla_body`."""
    _require_act(qparams)
    h = torch.relu(_conv(x.to(torch.bfloat16), qparams["level1"]))
    chain = [
        (lambda b, i=i: _light53_i8_xla(b, qparams[f"body53_{i}"]), _LIGHT53_RADIUS)
        for i in range(n_body53)
    ] + [
        (lambda b, i=i: _light_i8_xla(b, qparams[f"light_{i}"]), _LIGHT_RADIUS)
        for i in range(n_light)
    ]
    for k in range(0, len(chain), max(1, seg)):
        part = chain[k : k + max(1, seg)]
        h = _tiled_chain(h, [f for f, _ in part], [r for _, r in part], tile)
    return h


def apply_didbl_int8_xla_tail(qparams: Any, h: torch.Tensor, n_tail53: int = 2, scale: int = 4,
                              dynamic: bool = False, upsampler: str = "tf1_bilinear") -> torch.Tensor:
    """bf16 x4 upsample (or the subpixel head: its conv on X4, static or, with
    ``dynamic``, per-sample, rounded to bf16, then depth_to_space), the int8
    HR Light53 blocks (static per-channel, or per-sample dynamic with
    ``dynamic``), bf16 out conv + relu -> float32.  ``IEK_INT8_UPQ`` (static,
    ``n_tail53`` >= 1) fuses the x4 into the first block
    (:func:`_light53_i8_xla_upfused`); else ``IEK_INT8_UPMM`` runs the x4
    as two dense contractions (``resize_bilinear_tf1``)."""
    h = h.to(torch.bfloat16)
    start = 0
    if upsampler == "subpixel":
        p = qparams["subpixel_conv"]
        if dynamic:
            t = int8_conv3_dyn(h, p["q"], p["s"], p["bias"], acc=_int8_acc())
        else:
            t = int8_conv3(h, p["qf"], p["sf"], p["bias"], p["actc"]["x"], acc=_int8_acc())
        h = depth_to_space(t.to(torch.bfloat16), scale, order="dcr")
    elif _knob("IEK_INT8_UPQ") and not dynamic and n_tail53 >= 1:
        h = _light53_i8_xla_upfused(h, qparams["tail53_0"], scale)
        start = 1
    elif _knob("IEK_INT8_UPMM"):
        # the einsums' output is not channels-last; the kernels take contiguous NHWC
        h = resize_bilinear_tf1(h, (scale * int(h.shape[-3]), scale * int(h.shape[-2]))).contiguous()
    else:
        with span(SPAN_UPSAMPLE):
            h = upsample_phase_tf1(h, scale)
    with span(SPAN_BLOCK):
        for i in range(start, n_tail53):
            p = qparams[f"tail53_{i}"]
            h = _light53_i8_xla_dyn(h, p) if dynamic else _light53_i8_xla(h, p)
    return torch.relu(_conv(h, qparams["out"])).to(torch.float32)


def apply_didbl_int8_xla(qparams: Any, x: torch.Tensor, n_body53: int = 16, n_light: int = 6,
                         n_tail53: int = 2, scale: int = 4,
                         upsampler: str = "tf1_bilinear") -> torch.Tensor:
    """(N, H, W, 3) [0,1] -> (N, 4H, 4W, 3): the didbl graph with every
    residual-block conv in int8 (per-channel static scales folded into the
    weights); identity paths unquantized, bf16 activations between blocks."""
    h = apply_didbl_int8_xla_body(qparams, x, n_body53=n_body53, n_light=n_light)
    return apply_didbl_int8_xla_tail(qparams, h, n_tail53=n_tail53, scale=scale, upsampler=upsampler)
