"""TF1 bilinear resampling (mirror of ``ops/resize.py``, the didbl subset).

``resize_bilinear_tf1`` is the in-network x4 of the ``pallas`` forward: two
float32 contractions with dense (out, in) weight matrices built in numpy.
``upsample_phase_tf1`` is the closed form the module forward uses: per axis
``out[f*k + r] = (1 - r/f)*in[k] + (r/f)*in[k+1]``, last row clamped.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "resize_weight_matrix",
    "resize2d",
    "resize_bilinear_tf1",
    "upsample_phase_tf1",
]


@functools.lru_cache(maxsize=None)
def resize_weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """Dense (out_size, in_size) float32 resampling matrix for one axis.

    Only ``tf1_bilinear`` is ported: TF1 ``resize_bilinear`` with
    align_corners=False, ``src = dst * in/out``, edge-clamped.
    """
    if in_size <= 0 or out_size <= 0:
        raise ValueError("sizes must be positive")
    if method != "tf1_bilinear":
        raise NotImplementedError(
            f"resize method {method!r} is not yet ported in image_enhance_keras_tpu_torch"
        )
    scale = in_size / out_size
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


def resize2d(x: torch.Tensor, out_hw: tuple[int, int], method: str = "tf1_bilinear") -> torch.Tensor:
    """Resize the (H, W) axes of a (..., H, W, C) float tensor by two contractions."""
    h, w = int(x.shape[-3]), int(x.shape[-2])
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x
    wh = torch.from_numpy(resize_weight_matrix(h, oh, method)).to(x.device, x.dtype)
    ww = torch.from_numpy(resize_weight_matrix(w, ow, method)).to(x.device, x.dtype)
    y = torch.einsum("oh,...hwc->...owc", wh, x)
    return torch.einsum("pw,...owc->...opc", ww, y)


def resize_bilinear_tf1(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """TF1 ``tf.image.resize_bilinear`` (align_corners=False) parity resize."""
    return resize2d(x, out_hw, "tf1_bilinear")


def upsample_phase_tf1(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor TF1 bilinear upsample as phase interleaving.

    Same construction as the JAX ``_upsample_phase_xla``: H pass, then W
    pass; each phase is ``a*(1 - r/f) + next*(r/f)`` in ``x``'s dtype.
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
