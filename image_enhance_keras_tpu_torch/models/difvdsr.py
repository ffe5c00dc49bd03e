"""Difvdsr ("difvdsr"), the diff-VDSR refiner on a pre-upscaled input (mirror of ``models/difvdsr.py``).

  input (N, H, W, 3) in [0, 1], already bicubic-upscaled
  -> 3x3 conv, 192 feats, relu     (level1, frozen in training)
  -> 32x DiffBlock, leaky relu 0.2 (diff_i)
  -> 3x3 conv -> 3 feats, relu     (out)

No in-network upscale and no body/tail split.  Profiles as in
``models/didbl.py`` (float32, bf16, ``mixed``).  Submodule names are the
flax param scopes.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from image_enhance_keras_tpu_torch.models.blocks import DiffBlock, make_conv, profile_dtype

__all__ = ["Difvdsr"]


class Difvdsr(nn.Module):
    """Refiner; NHWC in [0,1] -> NHWC of the same size in [0,inf)."""

    #: top-level parameter groups the trainer keeps frozen
    frozen_params = ("level1",)

    def __init__(self, features: int = 192, n_blocks: int = 32, dtype: Any = None, mixed: bool = False):
        super().__init__()
        self.dtype = profile_dtype(dtype)
        self.mixed = mixed
        self.features = features
        self.n_blocks = n_blocks
        pk = dict(dtype=self.dtype, mixed=mixed)
        self.level1 = make_conv(features, (3, 3), in_features=3, **pk)
        for i in range(n_blocks):
            self.add_module(f"diff_{i}", DiffBlock(features, leaky_slope=0.2, three_way=True, **pk))
        self.out = make_conv(3, (3, 3), in_features=features, **pk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.mixed:
            x = x.to(self.dtype)
        h = torch.relu(self.level1(x))
        for i in range(self.n_blocks):
            h = getattr(self, f"diff_{i}")(h)
        return torch.relu(self.out(h)).to(torch.float32)
