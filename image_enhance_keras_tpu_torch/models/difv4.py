"""Difvdsr4 ("difv4"), the progressive 2x + 2x generator (mirror of ``models/difv4.py``).

  input (N, H, W, 3) in [0, 1]
  -> 1x1 conv, 256 feats, relu             (level1)
  -> 6x LightBlock, leaky relu 0.001       (head_i)
  -> TF1 bilinear x2
  -> long skip around 20x LightBlock       (mid_i)
  -> TF1 bilinear x2 (scale=4 only)
  -> 6x LightBlock                         (tail_i)
  -> 3x3 conv -> 3 feats, relu             (out)

``scale=2`` is the single-2x variant: the same towers without the second
x2.  Split mode: ``body`` runs through the mid tower and the long skip
(2x the input), ``tail_fn`` the rest (``split_tail_method``); the tail's
receptive field is 13 pixels, so ``split_halo`` is 8 rows of the 2x map
at x4 and 14 at x2.  Profiles as in ``models/didbl.py`` (float32, bf16,
``mixed``).  Submodule names are the flax param scopes.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from image_enhance_keras_tpu_torch.models.blocks import LightBlock, make_conv, profile_dtype
from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_tf1

__all__ = ["Difvdsr4"]

#: the head tower's leaky relu slope
HEAD_LEAKY = 0.001


class Difvdsr4(nn.Module):
    """x4 (or x2) generator; NHWC in [0,1] -> NHWC x``scale`` in [0,inf)."""

    #: body output is 2x the input; the tail method split mode calls
    body_upscale = 2
    split_tail_method = "tail_fn"

    def __init__(self, features: int = 256, n_head: int = 6, n_mid: int = 20, n_tail: int = 6,
                 scale: int = 4, dtype: Any = None, mixed: bool = False):
        super().__init__()
        if scale not in (2, 4):
            raise ValueError(f"Difvdsr4 supports scale 2 or 4, got {scale}")
        self.dtype = profile_dtype(dtype)
        self.mixed = mixed
        self.features = features
        self.n_head = n_head
        self.n_mid = n_mid
        self.n_tail = n_tail
        self.scale = scale
        pk = dict(dtype=self.dtype, mixed=mixed)
        self.level1 = make_conv(features, (1, 1), in_features=3, **pk)
        for i in range(n_head):
            self.add_module(f"head_{i}", LightBlock(features, leaky_slope=HEAD_LEAKY, **pk))
        for i in range(n_mid):
            self.add_module(f"mid_{i}", LightBlock(features, **pk))
        for i in range(n_tail):
            self.add_module(f"tail_{i}", LightBlock(features, **pk))
        self.out = make_conv(3, (3, 3), in_features=features, **pk)

    @property
    def tail_upscale(self) -> int:
        return self.scale // 2

    @property
    def split_halo(self) -> int:
        return 8 if self.scale == 4 else 14

    def body(self, x: torch.Tensor) -> torch.Tensor:
        """Head tower at 1x -> x2 -> mid tower + long skip, at 2x."""
        if not self.mixed:
            x = x.to(self.dtype)
        h = torch.relu(self.level1(x))
        for i in range(self.n_head):
            h = getattr(self, f"head_{i}")(h)
        h = upsample_phase_tf1(h, 2)
        skip = h
        for i in range(self.n_mid):
            h = getattr(self, f"mid_{i}")(h)
        return h + skip

    def tail_fn(self, h: torch.Tensor) -> torch.Tensor:
        """(x2 at scale=4) + tail tower + out conv -> float32."""
        if not self.mixed:
            h = h.to(self.dtype)
        if self.scale == 4:
            h = upsample_phase_tf1(h, 2)
        for i in range(self.n_tail):
            h = getattr(self, f"tail_{i}")(h)
        return torch.relu(self.out(h)).to(torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail_fn(self.body(x))
