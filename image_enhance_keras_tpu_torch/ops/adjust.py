"""Pixel adjustments (mirror of ``ops/adjust.py``): gamma, contrast and GAN
label smoothing as tensor expressions, where the reference loops over pixels."""

from __future__ import annotations

import torch

__all__ = ["set_gamma", "set_contrast", "smooth_gan_labels"]


def set_gamma(img: torch.Tensor, gamma: float) -> torch.Tensor:
    """Gamma adjust on uint8-range data: round(255 * clip(x / 255, 0, 1) ** gamma),
    clipped to [0, 255], float32.  The division is by a tensor, which on CUDA
    rounds the quotient where a Python scalar would multiply by its reciprocal."""
    x = img.to(torch.float32) / torch.tensor(255.0, device=img.device)
    y = torch.pow(torch.clamp(x, 0.0, 1.0), gamma) * 255.0
    return torch.clamp(torch.round(y), 0.0, 255.0)


def set_contrast(img: torch.Tensor, factor: float, pivot: float = 127.5) -> torch.Tensor:
    """Linear contrast about a pivot: round((x - pivot) * factor + pivot), clipped to [0, 255]."""
    y = (img.to(torch.float32) - pivot) * factor + pivot
    return torch.clamp(torch.round(y), 0.0, 255.0)


def smooth_gan_labels(y: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """GAN label smoothing: zeros become U[0, 0.3), ones U[0.7, 1.2).

    Draws from ``generator`` (on y's device), where JAX takes a PRNG key:
    the same generator state gives the same labels."""
    lo = torch.rand(y.shape, generator=generator, device=y.device) * 0.3
    hi = torch.rand(y.shape, generator=generator, device=y.device) * 0.5 + 0.7
    return torch.where(y == 0, lo, hi)
