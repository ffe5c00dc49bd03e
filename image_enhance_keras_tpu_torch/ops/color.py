"""Colour-space transforms with skimage / ITU-R BT.601 constants (mirror of ``ops/color.py``).

The reference scores on the Y channel of skimage ``rgb2ycbcr``.  Float32
throughout; the 3x3 products are written out as sums over the channels, so
no matrix unit (and no TF32) is involved on the card.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rgb2ycbcr", "ycbcr2rgb", "rgb2y", "im2double", "im2double_minmax"]

# ITU-R BT.601 "full-range RGB -> studio-range YCbCr" matrix, as used by
# skimage.color.rgb2ycbcr (inputs scaled to [0, 1]).
_RGB2YCBCR = np.array(
    [
        [65.481, 128.553, 24.966],
        [-37.797, -74.203, 112.0],
        [112.0, -93.786, -18.214],
    ],
    dtype=np.float32,
)
_YCBCR_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float32)


def _mix(x: torch.Tensor, m: np.ndarray, offset: np.ndarray | None) -> torch.Tensor:
    """out[..., k] = sum_c x[..., c] * m[k, c] (+ offset[k]), in float32."""
    outs = []
    for k in range(m.shape[0]):
        acc = x[..., 0] * float(m[k, 0]) + x[..., 1] * float(m[k, 1]) + x[..., 2] * float(m[k, 2])
        outs.append(acc + float(offset[k]) if offset is not None else acc)
    return torch.stack(outs, dim=-1)


def im2double(x: torch.Tensor) -> torch.Tensor:
    """Reference ``im2double``: scale 0..255 data to 0..1 floats.

    Divides by a tensor, as JAX divides: torch's CUDA division by a Python
    scalar multiplies by its reciprocal, which differs from the quotient by
    one ulp for 126 of the 256 uint8 values."""
    xf = x.to(torch.float32)
    return xf / torch.full((), 255.0, dtype=torch.float32, device=xf.device)


def im2double_minmax(x: torch.Tensor) -> torch.Tensor:
    """Reference ``im2doubleZ``: min-max normalise to [0, 1]."""
    xf = x.to(torch.float32)
    lo, hi = xf.min(), xf.max()
    return (xf - lo) / (hi - lo)


def rgb2ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """RGB (uint8 or float 0..255) -> YCbCr floats, Y in [16, 235] (skimage on uint8)."""
    return _mix(im2double(rgb), _RGB2YCBCR, _YCBCR_OFFSET)


def rgb2y(rgb: torch.Tensor) -> torch.Tensor:
    """Just the luma channel (the NTIRE scoring channel)."""
    return _mix(im2double(rgb), _RGB2YCBCR[:1], _YCBCR_OFFSET[:1])[..., 0]


def ycbcr2rgb(ycbcr: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb2ycbcr`; returns RGB floats in 0..255 (unclipped)."""
    inv = (np.linalg.inv(_RGB2YCBCR.astype(np.float64)) * 255.0).astype(np.float32)
    return _mix(ycbcr.to(torch.float32) - torch.from_numpy(_YCBCR_OFFSET).to(ycbcr.device), inv, None)
