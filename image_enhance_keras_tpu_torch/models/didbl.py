"""DifvdsrDouble ("didbl"), the x4 generator (mirror of ``models/didbl.py``).

  input (N, H, W, 3) in [0, 1]
  -> 1x1 conv, 128 feats, relu        (level1)
  -> 16x Light53Block                 (body53_i)
  -> 6x LightBlock                    (light_i)
  -> TF1 bilinear x4 phase upsample
  -> 2x Light53Block                  (tail53_i)
  -> 3x3 conv -> 3 feats, relu        (out)

``upsampler="subpixel"`` replaces the x4 by ``subpixel_conv`` (3x3,
features -> features * 16, under the tail's profile) and
``depth_to_space(.., 4, "dcr")``.  Either head runs in float32 or bf16 (``dtype``: the body and the
tail cast their input to it, every conv runs in it, parameters stay
float32, the output is float32).  ``mixed`` (with bf16) makes every conv
the mixed conv of ``models/blocks.py``: no cast of the input, float32
activations throughout.  ``mixed_tail`` keeps the body pure bf16 and makes
only the tail's convs mixed: the x4 runs on bf16, the first tail block
promotes its bf16 input to float32.  Submodule names are the flax param
scopes, so the npz checkpoints load one to one.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from image_enhance_keras_tpu_torch.models.blocks import Light53Block, LightBlock, make_conv, profile_dtype
from image_enhance_keras_tpu_torch.ops.pixel_shuffle import depth_to_space
from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_tf1
from image_enhance_keras_tpu_torch.utils.profiling import SPAN_BLOCK, SPAN_UPSAMPLE, span

__all__ = ["DifvdsrDouble"]


class DifvdsrDouble(nn.Module):
    """x4 super-resolution generator; NHWC in [0,1] -> NHWC x4 in [0,inf)."""

    def __init__(self, features: int = 128, n_body53: int = 16, n_light: int = 6, n_tail53: int = 2,
                 scale: int = 4, upsampler: str = "tf1_bilinear", dtype: Any = None,
                 mixed: bool = False, mixed_tail: bool = False):
        super().__init__()
        if upsampler not in ("tf1_bilinear", "subpixel"):
            raise ValueError(f"unknown upsampler {upsampler!r}")
        self.dtype = profile_dtype(dtype)
        self.mixed = mixed
        self.features = features
        self.n_body53 = n_body53
        self.n_light = n_light
        self.n_tail53 = n_tail53
        self.scale = scale
        self.upsampler = upsampler
        pk = dict(dtype=self.dtype, mixed=mixed)
        # tail convs are mixed under either profile, body convs only under mixed
        pk_tail = dict(dtype=self.dtype, mixed=mixed or mixed_tail)
        self.level1 = make_conv(features, (1, 1), in_features=3, **pk)
        for i in range(n_body53):
            self.add_module(f"body53_{i}", Light53Block(features, **pk))
        for i in range(n_light):
            self.add_module(f"light_{i}", LightBlock(features, **pk))
        if upsampler == "subpixel":
            self.subpixel_conv = make_conv(features * scale * scale, (3, 3), in_features=features, **pk_tail)
        for i in range(n_tail53):
            self.add_module(f"tail53_{i}", Light53Block(features, **pk_tail))
        self.out = make_conv(3, (3, 3), in_features=features, **pk_tail)

    @property
    def split_halo(self) -> int:
        """LR halo the split-mode tail needs: ceil((3*n_tail53 + 1) / scale) + 1."""
        rf_hr = 3 * self.n_tail53 + 1
        return -(-rf_hr // self.scale) + 1

    def body(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-upsample tower at LR: level1 + Light53 blocks + Light blocks."""
        if not self.mixed:  # mixed keeps activations float32; its convs round their inputs
            x = x.to(self.dtype)
        h = torch.relu(self.level1(x))
        with span(SPAN_BLOCK):
            for i in range(self.n_body53):
                h = getattr(self, f"body53_{i}")(h)
            for i in range(self.n_light):
                h = getattr(self, f"light_{i}")(h)
        return h

    def tail(self, h: torch.Tensor) -> torch.Tensor:
        """x4 upsample (or the subpixel head) + post-upsample Light53 blocks + out conv -> float32."""
        if not self.mixed:  # an identity under mixed_tail: the body handed over bf16
            h = h.to(self.dtype)
        if self.upsampler == "tf1_bilinear":
            with span(SPAN_UPSAMPLE):
                h = upsample_phase_tf1(h, self.scale)
        else:
            h = depth_to_space(self.subpixel_conv(h), self.scale, order="dcr")
        with span(SPAN_BLOCK):
            for i in range(self.n_tail53):
                h = getattr(self, f"tail53_{i}")(h)
        return torch.relu(self.out(h)).to(torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.body(x))
