"""Iterative back-projection (mirror of ``ops/backproject.py``): refine a
finished SR frame so that its PIL-bicubic downscale matches the LR input.

Each step projects the estimate down with the evaluation's degradation
(PIL bicubic /scale), and adds the bicubic up-projection of the residual
against the LR input.  Both projections are ``ops.resize.resize_bicubic_pil``:
two float32 contractions with dense weight matrices (TF32 off on the card).
"""

from __future__ import annotations

import torch

from image_enhance_keras_tpu_torch.ops.resize import resize_bicubic_pil

__all__ = ["back_project"]


def back_project(sr: torch.Tensor, lr: torch.Tensor, iters: int = 3, step: float = 1.0) -> torch.Tensor:
    """(..., Hs, Ws, C) SR estimate and (..., Hl, Wl, C) LR input, uint8 or
    float in [0, 255], Hs/Hl and Ws/Wl the integer scale -> uint8 of sr's
    shape after ``iters`` steps of gain ``step``."""
    if sr.shape[-3] % lr.shape[-3] or sr.shape[-2] % lr.shape[-2]:
        raise ValueError(f"sr {tuple(sr.shape[-3:-1])} is not an integer multiple of lr {tuple(lr.shape[-3:-1])}")
    x = sr.to(torch.float32)
    y = lr.to(torch.float32)
    lr_hw = (lr.shape[-3], lr.shape[-2])
    sr_hw = (sr.shape[-3], sr.shape[-2])
    for _ in range(int(iters)):
        down = resize_bicubic_pil(x, lr_hw)
        x = x + step * resize_bicubic_pil(y - down, sr_hw)
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)
