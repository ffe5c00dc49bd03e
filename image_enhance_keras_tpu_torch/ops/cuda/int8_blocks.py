"""int8 Light53 and Light residual blocks: CUDA kernels and their plain versions.

Counterpart of ``ops/pallas/int8_blocks.py``.  ``light53_int8`` and
``light_int8`` keep the JAX signatures (x NHWC bf16 or float32, weights
HWIO int8 from :func:`quantize_weights_per_channel`, per-output-channel
float32 scales, float32 biases, ``act_scales``, ``tile``); the output has
x's dtype.  They check their arguments and call the ops
``iek::light53_int8`` and ``iek::light_int8`` (``ops/cuda/library.py``):
on a CUDA tensor the op launches the kernels of ``csrc/int8_blocks.cu``
(:func:`launch_light53_int8`, :func:`launch_light_int8`, the weights in
the packed layout of :func:`_packed`) or raises; on a CPU tensor it runs
the plain PyTorch versions below.  Each wrapper counts in ``.launches`` the
blocks its op ran on the kernels.  The kernels run the s8 x s8 -> s32 products on the
tensor cores (wgmma) and take exactly C = 128 channels (:data:`CUDA_CHANNELS`).

Two scale modes, as in JAX:

* static (calibrated ``act_scales``, the serving path): the TPU kernel's
  halo'd windows give exactly the whole-image SAME chain on the quantized
  codes, so ``tile`` has no effect on the result;
* dynamic (``act_scales=None``, the uncalibrated path of
  ``quantize_didbl_params`` without ``calib_x``): every TPU window
  quantizes its input window, and each branch's intermediate over the
  window's extended ring, with its own abs-max scale (dividing, not
  multiplying by the reciprocal), so the result depends on the window
  partition: H and W padded up to multiples of 8, windows of
  ``_pick_tile(h8, tile[0]) x _pick_tile(w8, tile[1])``.  The input abs-max
  spans the DMA'd window, ``_win_pad(halo) - 2 * halo`` columns right of
  the columns the convs read.

The plain versions compute the s8 x s8 -> s32 convolutions exactly, as
float64 convolutions of the integer codes (sums below 25*128*127^2 ~ 5.2e7,
exact in float64 and rounded back to integers), and every float step in the
kernels' order, so the kernels agree with them bit for bit.  The dynamic
ones unfold the windows into a batch and convolve it VALID.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from image_enhance_keras_tpu_torch.ops.cuda import _build, library

__all__ = [
    "quantize_weights_per_channel",
    "light53_int8",
    "light_int8",
    "launch_light53_int8",
    "launch_light_int8",
    "light53_int8_plain",
    "light_int8_plain",
    "light53_int8_dynamic_plain",
    "light_int8_dynamic_plain",
]

#: channels the CUDA kernels take: the N of their wgmma tile, and the input
#: window they hold in shared memory for all 25 (or 9) taps
CUDA_CHANNELS = 128
#: activation dtypes the blocks take (the output has x's dtype)
ACT_DTYPES = (torch.bfloat16, torch.float32)
#: float32(1/127): dynamic scales multiply by it (see :func:`_scale_dyn`)
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def quantize_weights_per_channel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, k, Cin, Cout) float -> (int8 weights, (Cout,) float32 scales).

    The scales divide by a tensor: torch's CUDA division by a Python scalar
    multiplies by its reciprocal, which is not JAX's (or the CPU's) quotient."""
    w = w.to(torch.float32)
    amax = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)), 1e-12)
    scale = amax / torch.full_like(amax, 127.0)
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


def _fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add: the product is
    exact in float64, the sum is rounded to odd there (TwoSum), and rounding
    that to float32 is then the correctly rounded result."""
    p = torch.as_tensor(a, dtype=torch.float32).double() * torch.as_tensor(b, dtype=torch.float32).double()
    c = torch.as_tensor(c, dtype=torch.float32).double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(e > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((e != 0) & even & torch.isfinite(e), torch.nextafter(s, away), s)
    return s.to(torch.float32)


def _dequant(acc: torch.Tensor, s: torch.Tensor, sw: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc * (s * sw) + b with the product and the add fused (one rounding)."""
    return _fma(acc, s * sw, b)


def _light53_out(xf, a, b, res_scale, identity_scale):
    """identity * x + res * (a + b), the first product fused with the add (contiguous NHWC)."""
    return _fma(identity_scale, xf, res_scale * (a + b)).contiguous()


def _light_out(xf, u, res_scale):
    """x + res * u, fused (contiguous NHWC)."""
    return _fma(res_scale, u, xf).contiguous()


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
    return _light53_out(xf, a, b, res_scale, identity_scale).to(x.dtype)


def light_int8_plain(x, w1q, s1, b1, w2q, s2, b2, act_scales, res_scale: float = 0.1):
    """The int8 Light block with static scales (input, intermediate)."""
    xf = x.to(torch.float32)
    sx, st = act_scales[0], act_scales[1]
    t = _quant(torch.relu(_dequant(_conv_s32(_quant(xf, sx), w1q), sx, s1, b1)), st)
    u = _dequant(_conv_s32(t, w2q), st, s2, b2)
    return _light_out(xf, u, res_scale).to(x.dtype)


# -- the TPU kernel's window grid (ops/pallas/int8_blocks.py:105-109, 221-245) --

def _round8(v: int) -> int:
    return -(-v // 8) * 8


def _win_pad(halo: int) -> int:
    """Columns a window holds beyond its tw: 2*halo rounded up to 8."""
    return -(-(2 * halo) // 8) * 8


def _pick_tile(dim: int, target: int) -> int:
    """Largest multiple of 8 that divides the 8-aligned ``dim`` and is at most ``target``."""
    for t in range(min(target, dim) // 8 * 8, 0, -8):
        if dim % t == 0:
            return t
    return dim


def _pad_for_grid(x: torch.Tensor, halo: int) -> tuple[torch.Tensor, int, int]:
    """Zero-pad (N, H, W, C): top/left ``halo``, bottom to h8 plus ``halo``,
    right to w8 plus the window's remainder; returns (padded, h8, w8)."""
    _, h, w, _ = x.shape
    h8, w8 = _round8(h), _round8(w)
    return F.pad(x, (0, 0, halo, (w8 - w) + _win_pad(halo) - halo, halo, (h8 - h) + halo)), h8, w8


def window_grid(h: int, w: int, tile: tuple[int, int]) -> tuple[int, int, int, int]:
    """(th, tw, h8, w8): the windows of an (h, w) image under ``tile``."""
    h8, w8 = _round8(h), _round8(w)
    return _pick_tile(h8, tile[0]), _pick_tile(w8, tile[1]), h8, w8


def _scale_dyn(t: torch.Tensor) -> torch.Tensor:
    """Per-window scale max(abs-max, 1e-12) / 127 of a (B, h, w, C) batch, as (B, 1, 1, 1).

    As JAX computes it: XLA folds the division by the constant into a product
    with its float32 reciprocal (the codes then divide by the scale)."""
    return torch.clamp_min(t.abs().amax(dim=(1, 2, 3), keepdim=True), 1e-12) * _INV127


def _quant_dyn(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Dynamic symmetric int8 codes (as float32): clamp(round(t / s), +-127)."""
    return torch.clamp(torch.round(t / s), -127.0, 127.0)


def _conv_valid_s32(q: torch.Tensor, wq: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Exact VALID conv of a (B, h, w, Cin) batch of codes down to (B, oh, ow, Cout), float32."""
    k = int(wq.shape[0])
    q = q[:, :oh + k - 1, :ow + k - 1]
    y = F.conv2d(q.permute(0, 3, 1, 2).to(torch.float64), wq.permute(3, 2, 0, 1).to(torch.float64))
    return torch.round(y).permute(0, 2, 3, 1).to(torch.float32)


class _Windows:
    """The window batch of one block: (N*wy*wx, th + 2*halo, tw + _win_pad(halo), C)."""

    def __init__(self, xf: torch.Tensor, halo: int, tile: tuple[int, int]):
        n, self.h, self.w, c = xf.shape
        xp, h8, w8 = _pad_for_grid(xf, halo)
        self.th, self.tw, _, _ = window_grid(self.h, self.w, tile)
        self.n, self.wy, self.wx = n, h8 // self.th, w8 // self.tw
        u = xp.unfold(1, self.th + 2 * halo, self.th).unfold(2, self.tw + _win_pad(halo), self.tw)
        self.batch = u.permute(0, 1, 2, 4, 5, 3).reshape(n * self.wy * self.wx, *u.shape[-2:], c)

    def mask(self, d: int) -> torch.Tensor:
        """1.0 where a window's (th + 2d, tw + 2d) ring, from (r0 - d, c0 - d), lies in the image."""
        dev = self.batch.device
        rows = (torch.arange(self.wy, device=dev)[:, None] * self.th - d
                + torch.arange(self.th + 2 * d, device=dev)[None, :])
        cols = (torch.arange(self.wx, device=dev)[:, None] * self.tw - d
                + torch.arange(self.tw + 2 * d, device=dev)[None, :])
        inside = (((rows >= 0) & (rows < self.h))[:, None, :, None]
                  & ((cols >= 0) & (cols < self.w))[None, :, None, :])
        m = inside.to(torch.float32).reshape(1, self.wy * self.wx, *inside.shape[-2:], 1)
        return m.expand(self.n, -1, -1, -1, -1).reshape(-1, *inside.shape[-2:], 1)

    def stitch(self, t: torch.Tensor) -> torch.Tensor:
        """(N*wy*wx, th, tw, C) -> (N, H, W, C)."""
        c = t.shape[-1]
        t = t.reshape(self.n, self.wy, self.wx, self.th, self.tw, c).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(self.n, self.wy * self.th, self.wx * self.tw, c)[:, :self.h, :self.w]

    def ring(self, xq, sx, w1, s1, b1, d: int) -> torch.Tensor:
        """conv(k1) VALID to the (th + 2d, tw + 2d) ring, dequant, relu, border
        mask: each window's float32 intermediate ring."""
        th, tw = self.th, self.tw
        t = torch.relu(_dequant(_conv_valid_s32(xq, w1, th + 2 * d, tw + 2 * d), sx, s1, b1))
        return t * self.mask(d)

    def branch(self, xq, sx, w1, s1, b1, w2, s2, b2, d: int) -> torch.Tensor:
        """The ring, its own abs-max scale, conv(k2) VALID to (th, tw), dequant."""
        t = self.ring(xq, sx, w1, s1, b1, d)
        st = _scale_dyn(t)
        return _dequant(_conv_valid_s32(_quant_dyn(t, st), w2, self.th, self.tw), st, s2, b2)


def light53_int8_dynamic_plain(x, wa1q, sa1, ba1, wa2q, sa2, ba2, wb1q, sb1, bb1, wb2q, sb2, bb2,
                               tile: tuple[int, int] = (64, 128), res_scale: float = 0.1,
                               identity_scale: float = 0.9):
    """The int8 Light53 block with per-window dynamic scales over the TPU's windows."""
    xf = x.to(torch.float32)
    win = _Windows(xf, 3, tile)
    sx = _scale_dyn(win.batch)
    xq = _quant_dyn(win.batch, sx)
    a = win.stitch(win.branch(xq, sx, wa1q, sa1, ba1, wa2q, sa2, ba2, 2))
    b = win.stitch(win.branch(xq, sx, wb1q, sb1, bb1, wb2q, sb2, bb2, 1))
    return _light53_out(xf, a, b, res_scale, identity_scale).to(x.dtype)


def light_int8_dynamic_plain(x, w1q, s1, b1, w2q, s2, b2, tile: tuple[int, int] = (64, 128),
                             res_scale: float = 0.1):
    """The int8 Light block with per-window dynamic scales over the TPU's windows."""
    xf = x.to(torch.float32)
    win = _Windows(xf, 2, tile)
    sx = _scale_dyn(win.batch)
    u = win.stitch(win.branch(_quant_dyn(win.batch, sx), sx, w1q, s1, b1, w2q, s2, b2, 1))
    return _light_out(xf, u, res_scale).to(x.dtype)


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


def _check(x, convs, vectors, act_scales, act_shape: tuple, cuda_dtypes=ACT_DTYPES) -> None:
    """Validate what both paths take; on CUDA also what the kernels take.

    ``act_shape``: the shape of ``act_scales`` when given (C stands for the
    channels); ``cuda_dtypes``: the activation dtypes the kernels take."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in ACT_DTYPES:
        raise TypeError(f"int8 blocks take bfloat16 or float32 activations, got {x.dtype}")
    c = int(x.shape[-1])
    for w, k in convs:
        if tuple(w.shape) != (k, k, c, c) or w.dtype != torch.int8:
            raise ValueError(f"weights must be int8 {(k, k, c, c)}, got {w.dtype} {tuple(w.shape)}")
    for v in vectors:
        if tuple(v.shape) != (c,) or v.dtype != torch.float32:
            raise ValueError(f"scales and biases must be float32 ({c},), got {v.dtype} {tuple(v.shape)}")
    act_shape = tuple(c if d == "C" else d for d in act_shape)
    if act_scales is not None and (tuple(act_scales.shape) != act_shape
                                   or act_scales.dtype != torch.float32):
        raise ValueError(f"act_scales must be None or float32 {act_shape}, got {act_scales.dtype} "
                         f"{tuple(act_scales.shape)}")
    tensors = [x, *(w for w, _ in convs), *vectors] + ([] if act_scales is None else [act_scales])
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got one on {t.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"int8 blocks run on cpu or cuda tensors, not {x.device}")
    if x.dtype not in cuda_dtypes:
        raise TypeError(f"these CUDA kernels take {' or '.join(str(d)[6:] for d in cuda_dtypes)} x, "
                        f"got {x.dtype}")
    if c != CUDA_CHANNELS:
        raise ValueError(f"the CUDA kernels take C == {CUDA_CHANNELS}, got C={c}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _dyn_buffers(x: torch.Tensor, tile, n_branch: int, ring: int):
    """Window grid and scratch of a dynamic launch: (th, tw, h8, w8), the
    per-window abs-maxes [1 + n_branch][windows], one float32 intermediate
    ring (windows, th + 2*ring, tw + 2*ring, C) per branch, and its int8
    codes (the same shape) per branch."""
    n, h, w, c = (int(s) for s in x.shape)
    th, tw, h8, w8 = window_grid(h, w, tile)
    windows = n * (h8 // th) * (w8 // tw)
    shape = (windows, th + 2 * ring, tw + 2 * ring, c)
    numel = windows * shape[1] * shape[2] * c
    # one allocation, cut into 256-byte aligned views: abs-maxes, rings, codes
    n_amax = (1 + n_branch) * windows
    sizes = [-(-(4 * n_amax) // 256) * 256] + [4 * numel] * n_branch + [numel] * n_branch
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=x.device)
    views = list(torch.split(buf, sizes))
    amax = views[0].view(torch.float32)[:n_amax].view(1 + n_branch, windows)
    rings = [v.view(torch.float32).view(shape) for v in views[1:1 + n_branch]]
    codes = [v.view(torch.int8).view(shape) for v in views[1 + n_branch:]]
    return (th, tw, h8, w8), amax, rings, codes


def light53_int8(x, wa1q, sa1, ba1, wa2q, sa2, ba2, wb1q, sb1, bb1, wb2q, sb2, bb2,
                 res_scale: float = 0.1, identity_scale: float = 0.9,
                 tile: tuple[int, int] = (64, 128), act_scales=None):
    """int8 Light53 block, (N, H, W, C) bf16 or float32, SAME semantics.

    ``act_scales``: (3,) float32 calibrated scales (input, branch-a
    intermediate, branch-b intermediate), with which ``tile`` does not
    change the result; None quantizes every ``tile`` window dynamically.
    """
    _check(x, [(wa1q, 3), (wa2q, 5), (wb1q, 5), (wb2q, 3)],
           [sa1, ba1, sa2, ba2, sb1, bb1, sb2, bb2], act_scales, (3,))
    wa1q, wa2q, wb1q, wb2q = library.device_layout(x, _packed, wa1q, wa2q, wb1q, wb2q)
    return library.light53_int8(x, wa1q, sa1, ba1, wa2q, sa2, ba2, wb1q, sb1, bb1, wb2q, sb2, bb2,
                                float(res_scale), float(identity_scale), [int(t) for t in tile], act_scales)


def light_int8(x, w1q, s1, b1, w2q, s2, b2, res_scale: float = 0.1,
               tile: tuple[int, int] = (64, 128), act_scales=None):
    """int8 Light block (conv3-relu-conv3 residual), (N, H, W, C) bf16 or float32, SAME.

    ``act_scales``: (2,) float32 calibrated scales (input, intermediate);
    None quantizes every ``tile`` window dynamically.
    """
    _check(x, [(w1q, 3), (w2q, 3)], [s1, b1, s2, b2], act_scales, (2,))
    w1q, w2q = library.device_layout(x, _packed, w1q, w2q)
    return library.light_int8(x, w1q, s1, b1, w2q, s2, b2, float(res_scale), [int(t) for t in tile],
                              act_scales)


def launch_light53_int8(x, wa1p, sa1, ba1, wa2p, sa2, ba2, wb1p, sb1, bb1, wb2p, sb2, bb2,
                        res_scale: float, identity_scale: float, tile, act_scales) -> torch.Tensor:
    """K4 on CUDA tensors, the codes packed (:func:`_packed`): the CUDA
    implementation of ``iek::light53_int8``, static or dynamic."""
    convs = (wa1p, sa1, ba1, wa2p, sa2, ba2, wb1p, sb1, bb1, wb2p, sb2, bb2)
    _build.check_aligned(x, act_scales, *convs)
    lib = _build.library("int8_blocks")
    n, h, w, c = (int(s) for s in x.shape)
    f32 = int(x.dtype == torch.float32)
    wptrs = [t.data_ptr() for t in convs]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        if act_scales is None:
            grid, amax, (ta, tb), (qa, qb) = _dyn_buffers(x, tile, 2, 2)
            code = lib.iek_light53_int8_dynamic(
                x.data_ptr(), *wptrs, amax.data_ptr(), ta.data_ptr(), tb.data_ptr(), qa.data_ptr(),
                qb.data_ptr(), out.data_ptr(),
                n, h, w, c, *grid, f32, float(res_scale), float(identity_scale), _stream(x))
        else:
            ta = torch.empty(x.shape, dtype=torch.int8, device=x.device)
            tb = torch.empty_like(ta)
            code = lib.iek_light53_int8(
                x.data_ptr(), act_scales.data_ptr(), *wptrs, ta.data_ptr(), tb.data_ptr(),
                out.data_ptr(), n, h, w, c, f32, float(res_scale), float(identity_scale), _stream(x))
    _build.check(lib, code, "light53_int8")
    light53_int8.launches += 1
    return out


def launch_light_int8(x, w1p, s1, b1, w2p, s2, b2, res_scale: float, tile, act_scales) -> torch.Tensor:
    """K5 on CUDA tensors, the codes packed: the CUDA implementation of ``iek::light_int8``."""
    convs = (w1p, s1, b1, w2p, s2, b2)
    _build.check_aligned(x, act_scales, *convs)
    lib = _build.library("int8_blocks")
    n, h, w, c = (int(s) for s in x.shape)
    f32 = int(x.dtype == torch.float32)
    wptrs = [t.data_ptr() for t in convs]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        if act_scales is None:
            grid, amax, (t,), (q,) = _dyn_buffers(x, tile, 1, 1)
            code = lib.iek_light_int8_dynamic(
                x.data_ptr(), *wptrs, amax.data_ptr(), t.data_ptr(), q.data_ptr(), out.data_ptr(),
                n, h, w, c, *grid, f32, float(res_scale), _stream(x))
        else:
            t = torch.empty(x.shape, dtype=torch.int8, device=x.device)
            code = lib.iek_light_int8(
                x.data_ptr(), act_scales.data_ptr(), *wptrs, t.data_ptr(), out.data_ptr(),
                n, h, w, c, f32, float(res_scale), _stream(x))
    _build.check(lib, code, "light_int8")
    light_int8.launches += 1
    return out


light53_int8.launches = 0
light_int8.launches = 0
