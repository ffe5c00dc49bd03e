"""TF1 and PIL resampling (mirror of ``ops/resize.py``).

``resize_weight_matrix`` builds the dense (out, in) matrix of one axis for
every method JAX has (``tf1_bilinear``, ``tf1_bicubic``, ``tf1_nearest``,
``pil_nearest``, ``pil_bilinear``, ``pil_bicubic``, ``pil_lanczos``,
``pil_box``), in numpy, as JAX does.  ``resize2d`` contracts (H, W) with
two of them: ``resize_bilinear_tf1`` is the in-network x4 of the ``pallas``
forward and of ``IEK_INT8_UPMM``, ``upscale_bilinear_x4`` the model's x4 as
a resize, ``resize_bicubic_pil`` the float PIL-bicubic resize of
back-projection.
``upsample_phase_tf1`` is the closed form the module and int8 forwards use:
per axis ``out[f*k + r] = (1 - r/f)*in[k] + (r/f)*in[k+1]``, last row
clamped; it is the op ``iek::upsample_phase_tf1`` (``ops/cuda/library.py``),
which runs the CUDA kernel on a CUDA tensor (``ops/cuda/upsample.py``) and
the plain construction on a CPU tensor.  ``resize_pil_uint8`` is
PIL's uint8 resampling under any PIL method (bicubic by default, which int8
calibration uses to degrade images to the serving distribution).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "resize_weight_matrix",
    "resize2d",
    "resize_bilinear_tf1",
    "resize_bicubic_pil",
    "upscale_bilinear_x4",
    "resize_pil_uint8",
    "upsample_phase_plain",
    "upsample_phase_tf1",
]


def _kernel_triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _kernel_cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic, a=-0.5 the kernel of PIL BICUBIC (TF1 bicubic takes a=-0.75)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax < 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


def _kernel_lanczos3(x: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.sinc(x) * np.sinc(x / 3.0)
    return np.where(np.abs(x) < 3.0, np.nan_to_num(w), 0.0)


def _kernel_box(x: np.ndarray) -> np.ndarray:
    return np.where((x >= -0.5) & (x < 0.5), 1.0, 0.0)


#: PIL's convolution filters: (kernel, support at scale 1)
_PIL_KERNELS = {
    "pil_bilinear": (_kernel_triangle, 1.0),
    "pil_bicubic": (_kernel_cubic, 2.0),
    "pil_lanczos": (_kernel_lanczos3, 3.0),
    "pil_box": (_kernel_box, 0.5),
}


@functools.lru_cache(maxsize=None)
def resize_weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """Dense (out_size, in_size) float32 resampling matrix for one axis.

    Methods:
      * ``tf1_bilinear`` - TF1 ``resize_bilinear`` with align_corners=False,
        ``src = dst * in/out``, edge-clamped;
      * ``tf1_bicubic`` - TF1 ``resize_bicubic`` with align_corners=False:
        asymmetric coordinates, Keys cubic with a=-0.75, edge-clamped, not
        renormalised, the fraction quantised to TF's 1024-entry table;
      * ``tf1_nearest`` - TF1 ``resize_nearest_neighbor`` (floor of ``dst * in/out``);
      * ``pil_nearest`` - PIL NEAREST (the half-pixel centre, truncated);
      * ``pil_bilinear`` / ``pil_bicubic`` / ``pil_lanczos`` / ``pil_box`` -
        PIL convolution resampling: half-pixel centres, kernel support
        scaled by the downscale factor (antialias), weights normalised per row.
    """
    if in_size <= 0 or out_size <= 0:
        raise ValueError("sizes must be positive")
    scale = in_size / out_size
    if method == "tf1_bilinear":
        src = np.arange(out_size, dtype=np.float64) * scale
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        i0 = np.clip(i0, 0, in_size - 1)
        i1 = np.clip(i0 + 1, 0, in_size - 1)
        w = np.zeros((out_size, in_size), dtype=np.float64)
        rows = np.arange(out_size)
        w[rows, i0] += 1.0 - frac
        w[rows, i1] += frac
        return w.astype(np.float32)
    if method == "tf1_bicubic":
        table = 1024
        w = np.zeros((out_size, in_size), dtype=np.float64)
        for i in range(out_size):
            src = i * scale
            j0 = int(np.floor(src))
            frac = round((src - j0) * table) / table
            for t in range(-1, 3):
                w[i, min(max(j0 + t, 0), in_size - 1)] += float(_kernel_cubic(np.asarray(t - frac), a=-0.75))
        return w.astype(np.float32)
    if method in ("tf1_nearest", "pil_nearest"):
        if method == "tf1_nearest":
            src = np.minimum(np.floor(np.arange(out_size) * scale).astype(np.int64), in_size - 1)
        else:
            src = np.clip(((np.arange(out_size) + 0.5) * scale).astype(np.int64), 0, in_size - 1)
        w = np.zeros((out_size, in_size), dtype=np.float32)
        w[np.arange(out_size), src] = 1.0
        return w
    if method not in _PIL_KERNELS:
        raise ValueError(f"unknown resize method: {method!r}")
    kernel, base_support = _PIL_KERNELS[method]
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    inv = 1.0 / filterscale
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        js = np.arange(xmin, xmax)
        ws = kernel((js + 0.5 - center) * inv)
        total = ws.sum()
        if total != 0.0:
            ws = ws / total
        w[i, xmin:xmax] = ws
    return w.astype(np.float32)


def resize2d(x: torch.Tensor, out_hw: tuple[int, int], method: str = "tf1_bilinear") -> torch.Tensor:
    """Resize the (H, W) axes of a (..., H, W, C) tensor by two contractions
    in x's dtype; an integer x is promoted to float32 first (JAX's rule)."""
    h, w = int(x.shape[-3]), int(x.shape[-2])
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x
    if not x.is_floating_point():
        x = x.to(torch.float32)
    wh = torch.from_numpy(resize_weight_matrix(h, oh, method)).to(x.device, x.dtype)
    ww = torch.from_numpy(resize_weight_matrix(w, ow, method)).to(x.device, x.dtype)
    y = torch.einsum("oh,...hwc->...owc", wh, x)
    return torch.einsum("pw,...owc->...opc", ww, y)


def resize_bilinear_tf1(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """TF1 ``tf.image.resize_bilinear`` (align_corners=False) parity resize."""
    return resize2d(x, out_hw, "tf1_bilinear")


def resize_bicubic_pil(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """PIL / ``scipy.misc.imresize`` BICUBIC resize in float (antialiased downscale)."""
    return resize2d(x, out_hw, "pil_bicubic")


def upscale_bilinear_x4(x: torch.Tensor) -> torch.Tensor:
    """The in-network x4 upsample of the flagship model as a TF1 bilinear resize."""
    return resize_bilinear_tf1(x, (4 * int(x.shape[-3]), 4 * int(x.shape[-2])))


@functools.lru_cache(maxsize=None)
def _band(in_size: int, out_size: int, method: str) -> tuple[np.ndarray, np.ndarray]:
    """Each output's band of inputs with nonzero weight, as (out, taps) index
    and weight arrays in increasing input order, padded with weight 0."""
    wm = resize_weight_matrix(in_size, out_size, method)
    nz = wm != 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), in_size - 1 - nz[:, ::-1].argmax(1), 0)
    taps = int((last - first).max()) + 1
    idx = np.minimum(first[:, None] + np.arange(taps)[None, :], in_size - 1)
    wt = np.take_along_axis(wm, idx, 1) * (first[:, None] + np.arange(taps)[None, :] <= last[:, None])
    return idx.astype(np.int64), wt.astype(np.float32)


def _resample_axis(x: torch.Tensor, out_size: int, method: str, axis: int) -> torch.Tensor:
    """The contraction of ``axis`` with the resampling matrix, summed tap by
    tap in increasing input order, each product and sum rounded to float32
    (no fused multiply-add), as XLA's float32 dot sums a narrow contraction
    on the CPU; the same on every device."""
    idx, wt = _band(int(x.shape[axis]), int(out_size), method)
    shape = [1] * x.dim()
    shape[axis] = int(out_size)
    acc = None
    for j in range(idx.shape[1]):
        col = torch.from_numpy(idx[:, j]).to(x.device)
        term = torch.index_select(x, axis, col) * torch.from_numpy(wt[:, j]).to(x.device).reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def resize_pil_uint8(x: torch.Tensor, out_hw: tuple[int, int], method: str = "pil_bicubic") -> torch.Tensor:
    """PIL resampling with uint8 image semantics (``scipy.misc.imresize`` on uint8).

    Horizontal pass first, then the intermediate is rounded half up and
    clamped to [0, 255] (PIL's fixed-point ``(v + 0.5) >> PRECISION``), then
    the vertical pass, rounded and clamped again.  Input (..., H, W, C) uint8
    or float 0..255; output float32 holding exact uint8 values.  Each pass
    sums its taps as JAX's float32 contraction of a narrow input does on the
    CPU (:func:`_resample_axis`), so that intermediates on a .5 boundary
    round as JAX's do.
    """
    oh, ow = int(out_hw[0]), int(out_hw[1])
    xf = x.to(torch.float32)
    y = torch.clamp(torch.floor(_resample_axis(xf, ow, method, xf.dim() - 2) + 0.5), 0.0, 255.0)
    y = _resample_axis(y, oh, method, xf.dim() - 3)
    return torch.clamp(torch.floor(y + 0.5), 0.0, 255.0)


def upsample_phase_plain(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor TF1 bilinear upsample as phase interleaving, in plain torch.

    Same construction as the JAX ``_upsample_phase_xla``: H pass, then W
    pass; each phase is ``a*(1 - r/f) + next*(r/f)`` in ``x``'s dtype, each
    product and sum rounded to it.
    """
    f = int(factor)
    if f == 1:
        return x

    def axis_up(a: torch.Tensor, ax: int) -> torch.Tensor:
        n = a.shape[ax]
        nxt = torch.cat([a.narrow(ax, 1, n - 1), a.narrow(ax, n - 1, 1)], dim=ax)
        phases = [
            a * torch.tensor(1.0 - r / f, dtype=a.dtype) + nxt * torch.tensor(r / f, dtype=a.dtype)
            for r in range(f)
        ]
        up = torch.stack(phases, dim=ax + 1)
        return up.reshape(a.shape[:ax] + (n * f,) + a.shape[ax + 1 :])

    return axis_up(axis_up(x, x.dim() - 3), x.dim() - 2)


def upsample_phase_tf1(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor TF1 bilinear upsample, (..., H, W, C) -> (..., fH, fW, C).

    The op ``iek::upsample_phase_tf1``: :func:`upsample_phase_plain` on CPU
    tensors, the CUDA kernel on CUDA tensors, bit-identical to it and
    differentiable through it, which raises on what it cannot take (a dtype
    other than float32 or bfloat16, C not a multiple of 16 bytes); a tensor
    on another device is refused.
    """
    if int(factor) == 1:
        return x
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the upsample kernel runs on cuda tensors, not {x.device}")
    from image_enhance_keras_tpu_torch.ops.cuda import library

    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = library.upsample_phase_tf1(x.reshape(-1, h, w, c).contiguous(), int(factor))
    return y.reshape(*lead, *y.shape[1:])
