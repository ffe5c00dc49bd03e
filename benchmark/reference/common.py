"""Plain PyTorch pieces shared by the benchmark's references.

Everything the program derives at set-up is worked out again here from the
float weights and the inputs: the tile plan and the stitch of patch mode,
the per-channel int8 weight codes and the activation scales.  Nothing here
imports the program.  Each function follows the arithmetic of the port's
plain versions (NHWC activations, HWIO kernels), so that the references
round where the program rounds; integer convolutions are computed exactly.

``Numerics`` is the precision a reference runs in: the configuration's own
(float32 with TF32 off, int8 codes at +-127), or the control's step below
it (``tf32``: TF32 convolutions; ``qmax=7``: int4 codes).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

__all__ = [
    "Numerics", "im2double", "finalize_u8", "conv_nhwc", "round_tf32", "upsample_tf1",
    "quantize_weights", "quant_c", "conv_exact", "acc", "act", "plan_tiles", "upscale",
]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Numerics:
    """``tf32``: float convolutions on TF32 (the card's cuDNN flag; rounded
    operands on the CPU).  ``qmax``: the largest int code (127 for int8).
    ``bf16_via_f32``: bf16 convolutions as the float32 conv of the bf16
    values rounded once, on the card too (another summation order than
    cuDNN's bf16 conv: a sound alternative, read for information)."""

    tf32: bool = False
    qmax: int = 127
    bf16_via_f32: bool = False


def c32(v: float) -> torch.Tensor:
    """A float32 scalar, as the program's weakly typed constants become."""
    return torch.tensor(v, dtype=_F32)


def im2double(x: torch.Tensor) -> torch.Tensor:
    """uint8 data / 255 as float32, divided by a tensor (a quotient, not a product)."""
    xf = x.to(_F32)
    return xf / torch.full((), 255.0, dtype=_F32, device=xf.device)


def finalize_u8(y: torch.Tensor) -> torch.Tensor:
    """[0, 255]-domain float -> uint8, rounding half to even, clipped."""
    return torch.clamp(torch.round(y), 0.0, 255.0).to(torch.uint8)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, ties to even (finite values)."""
    i = t.to(_F32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(_F32)


@contextlib.contextmanager
def _cudnn_tf32(on: bool):
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None,
              num: Numerics = Numerics()) -> torch.Tensor:
    """SAME conv, (N, H, W, Cin) * (kh, kw, Cin, Cout) -> (N, H, W, Cout), in x's
    dtype.  bf16 on the CPU: the float32 conv of the bf16 values as contiguous
    NCHW, rounded once (torch's CPU bf16 conv sums in another order)."""
    kh, kw = int(kernel.shape[0]), int(kernel.shape[1])
    pad = (kh // 2, kw // 2)
    if x.dtype == torch.bfloat16 and (x.device.type == "cpu" or num.bf16_via_f32):
        y = F.conv2d(x.float().permute(0, 3, 1, 2).contiguous(), kernel.float().permute(3, 2, 0, 1).contiguous(),
                     None if bias is None else bias.float(), padding=pad)
        return y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
    if num.tf32 and x.device.type == "cpu":
        x, kernel = round_tf32(x), round_tf32(kernel)
    with _cudnn_tf32(num.tf32):
        y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def upsample_tf1(x: torch.Tensor, factor: int) -> torch.Tensor:
    """TF1 bilinear (align_corners=False, edge-clamped) x``factor`` as phase
    interleaving: an H pass, then a W pass, each phase
    ``a*(1 - r/f) + next*(r/f)`` in x's dtype, every product and sum rounded to it."""
    f = int(factor)

    def axis_up(a: torch.Tensor, ax: int) -> torch.Tensor:
        n = a.shape[ax]
        nxt = torch.cat([a.narrow(ax, 1, n - 1), a.narrow(ax, n - 1, 1)], dim=ax)
        phases = [a * torch.tensor(1.0 - r / f, dtype=a.dtype) + nxt * torch.tensor(r / f, dtype=a.dtype)
                  for r in range(f)]
        return torch.stack(phases, dim=ax + 1).reshape(a.shape[:ax] + (n * f,) + a.shape[ax + 1:])

    return axis_up(axis_up(x, x.dim() - 3), x.dim() - 2)


# -- int8 ----------------------------------------------------------------------

def quantize_weights(w: torch.Tensor, num: Numerics) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, k, Cin, Cout) -> (integer codes as int8, (Cout,) float32 scales):
    symmetric per output channel, scale = abs-max / qmax (a quotient)."""
    w = w.to(_F32)
    amax = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)), 1e-12)
    s = amax / torch.full_like(amax, float(num.qmax))
    return torch.clamp(torch.round(w / s), -num.qmax, num.qmax).to(torch.int8), s


def quant_c(x: torch.Tensor, s: torch.Tensor, num: Numerics) -> torch.Tensor:
    """Per-channel codes as float32: clamp(round(x * (1/s)), +-qmax)."""
    return torch.clamp(torch.round(x.to(_F32) * (1.0 / s)), -float(num.qmax), float(num.qmax))


def conv_exact(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact SAME conv of integer codes (N, H, W, Cin), held as floats, with
    integer HWIO weights: a float64 matrix product a tap, over blocks of rows,
    the exact sum rounded once to float32."""
    k = int(wq.shape[0])
    r = k // 2
    n, h, w, cin = (int(s) for s in q.shape)
    cout = int(wq.shape[-1])
    wd = wq.to(torch.float64)
    out = torch.empty((n, h, w, cout), dtype=_F32, device=q.device)
    per_row = n * (w + 2 * r) * max(cin, cout) * 8
    rb = max(1, min(h, (256 << 20) // per_row))
    for y0 in range(0, h, rb):
        y1 = min(h, y0 + rb)
        src = q[:, max(y0 - r, 0) : min(y1 + r, h)].to(torch.float64)
        src = F.pad(src, (0, 0, r, r, max(0, r - y0), max(0, y1 + r - h)))
        total = torch.zeros((n, y1 - y0, w, cout), dtype=torch.float64, device=q.device)
        for dy in range(k):
            for dx in range(k):
                total += src[:, dy : dy + y1 - y0, dx : dx + w, :] @ wd[dy, dx]
        out[:, y0:y1] = total.to(_F32)
    return out


def acc(q: torch.Tensor, wq: torch.Tensor, mode: str = "bf16") -> torch.Tensor:
    """The conv's accumulator as float32: the exact sum rounded to float32,
    then to bf16 under the default ``bf16`` accumulator."""
    y = conv_exact(q, wq)
    return y.to(torch.bfloat16).to(_F32) if mode == "bf16" else y


def act(y: torch.Tensor, slope: float | None) -> torch.Tensor:
    """relu, or leaky relu where(y >= 0, y, slope * y) with a float32 slope."""
    if slope is None:
        return torch.relu(y)
    return torch.where(y >= 0, y, c32(slope) * y)


# -- engine: fast and patch mode -------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    h: int
    w: int
    ph: int
    pw: int
    patch: int
    step: int
    cnt_h: int
    cnt_w: int
    scale: int
    crop: int

    @property
    def n_tiles(self) -> int:
        return self.cnt_h * self.cnt_w


def plan_tiles(h: int, w: int, patch: int = 96, step: int = 64, scale: int = 4, crop: int = 8) -> Plan:
    """The reference's padding: pad by ``patch``, then round both sides up to
    the next multiple of ``step`` past them when either is not one; tiles at
    ``step`` with start < padded - patch."""
    h1, w1 = h + patch, w + patch
    if h1 % step or w1 % step:
        h1, w1 = (h1 // step + 1) * step, (w1 // step + 1) * step

    def count(padded: int) -> int:
        limit = padded - patch
        return 0 if limit <= 0 else (limit - 1) // step + 1

    return Plan(h, w, h1, w1, patch, step, count(h1), count(w1), scale, crop)


def _stitch_axis(n_out: int, cnt: int, plan: Plan) -> torch.Tensor:
    """Canvas row y comes from tile ``clip((y - crop) // (step*s), 0, cnt-1)``
    (later tiles overwrite earlier ones past their crop), at its offset there."""
    ps, ss = plan.patch * plan.scale, plan.step * plan.scale
    y = torch.arange(n_out)
    own = torch.clamp(torch.div(y - plan.crop, ss, rounding_mode="floor"), 0, cnt - 1)
    return own * ps + torch.clamp(y - own * ss, 0, ps - 1)


def upscale(forward, img_u8: torch.Tensor, mode: str, patch: int = 96, step: int = 64, crop: int = 8,
            scale: int = 4, chunk: int = 8) -> torch.Tensor:
    """uint8 (H, W, 3) on the device -> uint8 (sH, sW, 3): ``forward`` over the
    whole frame (``fast``) or over the reference's overlapped tiles in
    column-major order, ``chunk`` at a time (``patch``), stitched and cropped."""
    if mode == "fast":
        return finalize_u8(forward(im2double(img_u8)[None])[0] * 255.0)
    if mode != "patch":
        raise ValueError(f"no reference for mode {mode!r}")
    plan = plan_tiles(int(img_u8.shape[0]), int(img_u8.shape[1]), patch, step, scale, crop)
    x = F.pad(img_u8.to(_F32), (0, 0, 0, plan.pw - plan.w, 0, plan.ph - plan.h))
    tiles = torch.stack([x[r * step : r * step + patch, c * step : c * step + patch]
                         for c in range(plan.cnt_w) for r in range(plan.cnt_h)])
    tiles = im2double(tiles)
    outs = torch.cat([forward(tiles[i : i + chunk]) for i in range(0, plan.n_tiles, chunk)]) * 255.0
    ps = patch * scale
    canvas = outs.reshape(plan.cnt_w, plan.cnt_h, ps, ps, 3).permute(1, 2, 0, 3, 4)
    canvas = canvas.reshape(plan.cnt_h * ps, plan.cnt_w * ps, 3)
    rows = _stitch_axis(plan.ph * scale, plan.cnt_h, plan).to(canvas.device)
    cols = _stitch_axis(plan.pw * scale, plan.cnt_w, plan).to(canvas.device)
    canvas = canvas.index_select(0, rows).index_select(1, cols)
    return finalize_u8(canvas[: plan.h * scale, : plan.w * scale])
