"""Separable and small filters (mirror of ``ops/filters.py``).

``separable_filter2d`` filters each channel with k_h along H and k_w along W
after edge padding (by default symmetric, scipy.ndimage's mode='reflect';
any ``np.pad`` mode JAX's ``jnp.pad`` takes); SSIM's window, the training
degradation's ``gaussian_blur`` and ``uniform_filter`` (scipy.ndimage's
box filter) run on it.  ``sharpen_pil``
is PIL's ImageFilter.SHARPEN.  Each pass is a weighted sum of shifted slices
in float32: no convolution library, and so no TF32, on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["gaussian_blur", "uniform_filter", "separable_filter2d", "sharpen_pil"]


@functools.lru_cache(maxsize=None)
def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Matches scipy.ndimage.gaussian_filter's discrete Gaussian."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def _pad(x: torch.Tensor, axis: int, before: int, after: int, mode: str) -> torch.Tensor:
    """``np.pad(mode=mode)`` along one axis: zeros for "constant", else a
    gather of the indices ``np.pad`` gives the axis' positions."""
    n = x.shape[axis]
    if mode == "constant":
        shape = list(x.shape)
        parts = []
        for k in (before, None, after):
            if k is None:
                parts.append(x)
            elif k:
                shape[axis] = k
                parts.append(x.new_zeros(shape))
        return torch.cat(parts, dim=axis)
    idx = np.pad(np.arange(n), (before, after), mode=mode)
    return torch.index_select(x, axis, torch.from_numpy(idx).to(x.device))


def _filter_axis(x: torch.Tensor, kern: np.ndarray, axis: int) -> torch.Tensor:
    """Valid correlation with ``kern`` along ``axis``: sum_i kern[i] * x[i : i + n - len + 1]."""
    m = x.shape[axis] - len(kern) + 1
    out = x.narrow(axis, 0, m) * float(kern[0])
    for i in range(1, len(kern)):
        out = out + x.narrow(axis, i, m) * float(kern[i])
    return out


def separable_filter2d(x: torch.Tensor, k_h: np.ndarray, k_w: np.ndarray | None = None,
                       pad_mode: str = "symmetric") -> torch.Tensor:
    """Apply a separable (k_h outer k_w) filter per channel with edge padding.

    x is (H, W), (H, W, C) or (N, H, W, C); the output has x's shape."""
    if k_w is None:
        k_w = k_h
    if x.dim() not in (2, 3, 4):
        raise ValueError(f"expected 2D/3D/4D array, got {x.dim()}D")
    ax_h, ax_w = (0, 1) if x.dim() == 2 else (x.dim() - 3, x.dim() - 2)
    k_h, k_w = np.asarray(k_h, np.float32), np.asarray(k_w, np.float32)
    # scipy origin-0 convention: an even-length kernel spans
    # [-(n//2), n - n//2 - 1], so pad n//2 before and (n-1)//2 after
    y = _pad(x, ax_h, len(k_h) // 2, (len(k_h) - 1) // 2, pad_mode)
    y = _filter_axis(y, k_h, ax_h)
    y = _pad(y, ax_w, len(k_w) // 2, (len(k_w) - 1) // 2, pad_mode)
    return _filter_axis(y, k_w, ax_w)


def gaussian_blur(x: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter parity over the spatial axes (per channel)."""
    if sigma <= 0:
        return x
    k = _gaussian_kernel1d(float(sigma), float(truncate))
    return separable_filter2d(x, k, k, pad_mode="symmetric")


def uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """scipy.ndimage.uniform_filter parity (mode='reflect') over the spatial axes."""
    k = np.full((size,), 1.0 / size, dtype=np.float32)
    return separable_filter2d(x, k, k, pad_mode="symmetric")


# PIL ImageFilter.SHARPEN: 3x3 kernel, scale 16, offset 0
_SHARPEN_KERNEL = np.array([[-2, -2, -2], [-2, 32, -2], [-2, -2, -2]], dtype=np.float32) / 16.0


def sharpen_pil(x: torch.Tensor) -> torch.Tensor:
    """PIL ImageFilter.SHARPEN parity: the 3x3 kernel on the interior, the
    1-px border copied from the source; float 0..255 in, the interior
    rounded and clipped to [0, 255] as PIL's uint8 store does.  The kernel's
    weights are dyadic, so on integer inputs every sum is exact."""
    if x.dim() not in (2, 3, 4):
        raise ValueError(f"expected 2D/3D/4D array, got {x.dim()}D")
    ax_h, ax_w = (0, 1) if x.dim() == 2 else (x.dim() - 3, x.dim() - 2)
    xf = x.to(torch.float32)
    hh, ww = x.shape[ax_h] - 2, x.shape[ax_w] - 2
    acc = None
    for i in range(3):
        for j in range(3):
            t = xf.narrow(ax_h, i, hh).narrow(ax_w, j, ww) * float(_SHARPEN_KERNEL[i, j])
            acc = t if acc is None else acc + t
    interior = torch.clamp(torch.round(acc), 0.0, 255.0).to(x.dtype)
    y = x.clone()
    y.narrow(ax_h, 1, hh).narrow(ax_w, 1, ww).copy_(interior)
    return y
