"""int8 Light53 and Light residual blocks: CUDA kernels and their plain versions.

Counterpart of ``ops/pallas/int8_blocks.py``.  ``light53_int8`` and
``light_int8`` keep the JAX signatures (x NHWC bf16, as the int8 forward
keeps its activations, weights HWIO int8 from
:func:`quantize_weights_per_channel`, per-output-channel float32
scales, float32 biases, ``act_scales``, ``tile``).  On a CUDA tensor they
launch the kernels of ``csrc/int8_blocks.cu`` (two launches per block, see
the notes there) or raise; on a CPU tensor they run the plain PyTorch
versions below.  Each wrapper counts in ``.launches`` the blocks it ran on
the kernels.  The kernels run the s8 x s8 -> s32 products on the tensor
cores (wgmma) and take exactly C = 128 channels (:data:`CUDA_CHANNELS`).

Only the static-scale serving mode is ported: with calibrated
``act_scales`` the TPU kernel's halo'd tiles give exactly the whole-image
SAME chain on the quantized codes, so ``tile`` has no effect on the result.
``act_scales=None`` (per-window dynamic abs-max scales, which do depend on
the TPU's window partition) raises ``NotImplementedError``.

The plain versions compute the s8 x s8 -> s32 convolutions exactly, as
float64 convolutions of the integer codes (sums below 25*128*127^2 ~ 5.2e7,
exact in float64 and rounded back to integers), and every float step in the
kernels' order, so the kernels agree with them bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from image_enhance_keras_tpu_torch.ops.cuda import _build

__all__ = [
    "quantize_weights_per_channel",
    "light53_int8",
    "light_int8",
    "light53_int8_plain",
    "light_int8_plain",
]

#: channels the CUDA kernels take: the N of their wgmma tile, and the input
#: window they hold in shared memory for all 25 (or 9) taps
CUDA_CHANNELS = 128


def quantize_weights_per_channel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, k, Cin, Cout) float -> (int8 weights, (Cout,) float32 scales)."""
    w = w.to(torch.float32)
    scale = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)), 1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _quant(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Static symmetric int8 codes (as float32): clamp(round(t * (1/s)), +-127)."""
    return torch.clamp(torch.round(t * torch.reciprocal(s)), -127.0, 127.0)


def _conv_s32(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact SAME conv of int8 codes (N,H,W,Cin) with int8 HWIO weights, as float32.

    float32(s32 sum), i.e. the sum rounded once to float32 as ``astype`` does.
    """
    k = int(wq.shape[0])
    y = F.conv2d(q.permute(0, 3, 1, 2).to(torch.float64),
                 wq.permute(3, 2, 0, 1).to(torch.float64), padding=k // 2)
    return torch.round(y).permute(0, 2, 3, 1).to(torch.float32)


def _dequant(acc: torch.Tensor, s: torch.Tensor, sw: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return acc * (s * sw) + b


def light53_int8_plain(x, wa1q, sa1, ba1, wa2q, sa2, ba2, wb1q, sb1, bb1, wb2q, sb2, bb2,
                       act_scales, res_scale: float = 0.1, identity_scale: float = 0.9):
    """The int8 Light53 block with static scales (input, branch a, branch b)."""
    xf = x.to(torch.float32)
    s0, s1, s2 = act_scales[0], act_scales[1], act_scales[2]
    xq = _quant(xf, s0)
    ta = _quant(torch.relu(_dequant(_conv_s32(xq, wa1q), s0, sa1, ba1)), s1)
    tb = _quant(torch.relu(_dequant(_conv_s32(xq, wb1q), s0, sb1, bb1)), s2)
    a = _dequant(_conv_s32(ta, wa2q), s1, sa2, ba2)
    b = _dequant(_conv_s32(tb, wb2q), s2, sb2, bb2)
    return (identity_scale * xf + res_scale * (a + b)).to(x.dtype)


def light_int8_plain(x, w1q, s1, b1, w2q, s2, b2, act_scales, res_scale: float = 0.1):
    """The int8 Light block with static scales (input, intermediate)."""
    xf = x.to(torch.float32)
    sx, st = act_scales[0], act_scales[1]
    t = _quant(torch.relu(_dequant(_conv_s32(_quant(xf, sx), w1q), sx, s1, b1)), st)
    u = _dequant(_conv_s32(t, w2q), st, s2, b2)
    return (xf + res_scale * u).to(x.dtype)


def _packed(wq: torch.Tensor) -> torch.Tensor:
    """HWIO int8 -> [ky*k + kx][cin/32][2][cout][16] int8, the kernels' B operand.

    Each (tap, 32-input-channel step) is one contiguous tile of cout x 32
    bytes, K-major: the two 16-byte halves of the step are cout*16 bytes
    apart, and within a half output channel ``co`` holds its 16 input
    channels at ``co*16``.  Cached on the weight tensor itself, so a quantized tree repacks once
    (inference tensors carry no version counter: they are not repacked
    after an in-place change).
    """
    version = None if wq.is_inference() else wq._version
    cached = getattr(wq, "_iek_packed", None)
    if cached is not None and cached[0] == version:
        return cached[1]
    k, _, cin, cout = (int(s) for s in wq.shape)
    packed = wq.reshape(k * k, cin // 32, 2, 16, cout).permute(0, 1, 2, 4, 3).contiguous()
    wq._iek_packed = (version, packed)
    return packed


def _check(x, convs, vectors, act_scales, n_act: int) -> None:
    """Validate what both paths take; on CUDA also what the kernels take."""
    if act_scales is None:
        raise NotImplementedError(
            "act_scales=None (dynamic per-window int8 scales) is not yet ported in "
            "image_enhance_keras_tpu_torch; pass calibrated act_scales"
        )
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int8 blocks take bfloat16 activations, got {x.dtype}")
    c = int(x.shape[-1])
    for w, k in convs:
        if tuple(w.shape) != (k, k, c, c) or w.dtype != torch.int8:
            raise ValueError(f"weights must be int8 {(k, k, c, c)}, got {w.dtype} {tuple(w.shape)}")
    for v in vectors:
        if tuple(v.shape) != (c,) or v.dtype != torch.float32:
            raise ValueError(f"scales and biases must be float32 ({c},), got {v.dtype} {tuple(v.shape)}")
    if tuple(act_scales.shape) != (n_act,) or act_scales.dtype != torch.float32:
        raise ValueError(f"act_scales must be float32 ({n_act},), got {act_scales.dtype} "
                         f"{tuple(act_scales.shape)}")
    tensors = [x, *(w for w, _ in convs), *vectors, act_scales]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got one on {t.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"int8 blocks run on cpu or cuda tensors, not {x.device}")
    if c != CUDA_CHANNELS:
        raise ValueError(f"the CUDA kernels take C == {CUDA_CHANNELS}, got C={c}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernels take 16-byte aligned tensors")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def light53_int8(x, wa1q, sa1, ba1, wa2q, sa2, ba2, wb1q, sb1, bb1, wb2q, sb2, bb2,
                 res_scale: float = 0.1, identity_scale: float = 0.9,
                 tile: tuple[int, int] = (64, 128), act_scales=None):
    """int8 Light53 block, (N, H, W, C) bf16, SAME semantics.

    ``act_scales``: (3,) float32 calibrated scales (input, branch-a
    intermediate, branch-b intermediate).  ``tile`` is accepted for the JAX
    signature; with static scales it does not change the result.
    """
    del tile
    _check(x, [(wa1q, 3), (wa2q, 5), (wb1q, 5), (wb2q, 3)],
           [sa1, ba1, sa2, ba2, sb1, bb1, sb2, bb2], act_scales, 3)
    if x.device.type == "cpu":
        return light53_int8_plain(x, wa1q, sa1, ba1, wa2q, sa2, ba2, wb1q, sb1, bb1,
                                  wb2q, sb2, bb2, act_scales, res_scale, identity_scale)
    lib = _build.library("int8_blocks")
    n, h, w, c = (int(s) for s in x.shape)
    ta = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    tb = torch.empty_like(ta)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.iek_light53_int8(
            x.data_ptr(), act_scales.data_ptr(),
            _packed(wa1q).data_ptr(), sa1.data_ptr(), ba1.data_ptr(),
            _packed(wa2q).data_ptr(), sa2.data_ptr(), ba2.data_ptr(),
            _packed(wb1q).data_ptr(), sb1.data_ptr(), bb1.data_ptr(),
            _packed(wb2q).data_ptr(), sb2.data_ptr(), bb2.data_ptr(),
            ta.data_ptr(), tb.data_ptr(), out.data_ptr(),
            n, h, w, c, float(res_scale), float(identity_scale), _stream(x),
        )
    _build.check(lib, code, "light53_int8")
    light53_int8.launches += 1
    return out


def light_int8(x, w1q, s1, b1, w2q, s2, b2, res_scale: float = 0.1,
               tile: tuple[int, int] = (64, 128), act_scales=None):
    """int8 Light block (conv3-relu-conv3 residual), (N, H, W, C) bf16, SAME.

    ``act_scales``: (2,) float32 calibrated scales (input, intermediate).
    """
    del tile
    _check(x, [(w1q, 3), (w2q, 3)], [s1, b1, s2, b2], act_scales, 2)
    if x.device.type == "cpu":
        return light_int8_plain(x, w1q, s1, b1, w2q, s2, b2, act_scales, res_scale)
    lib = _build.library("int8_blocks")
    n, h, w, c = (int(s) for s in x.shape)
    t = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.iek_light_int8(
            x.data_ptr(), act_scales.data_ptr(),
            _packed(w1q).data_ptr(), s1.data_ptr(), b1.data_ptr(),
            _packed(w2q).data_ptr(), s2.data_ptr(), b2.data_ptr(),
            t.data_ptr(), out.data_ptr(), n, h, w, c, float(res_scale), _stream(x),
        )
    _build.check(lib, code, "light_int8")
    light_int8.launches += 1
    return out


light53_int8.launches = 0
light_int8.launches = 0
