"""Residual blocks of the didbl generator (mirror of ``models/blocks.py``), float32.

Submodule and parameter names follow the flax tree (``conv_a1/kernel``), so
``models.weights.load_params`` maps the npz checkpoints one to one.
Activations are NHWC and kernels HWIO, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from image_enhance_keras_tpu_torch.ops.conv import conv2d_nhwc

__all__ = ["Conv", "LightBlock", "Light53Block", "make_conv", "check_profile"]


def check_profile(dtype: Any, mixed: bool) -> None:
    """Raise for precision profiles this slice does not run (float32 only)."""
    if mixed:
        raise NotImplementedError("the mixed profile is not yet ported in image_enhance_keras_tpu_torch")
    if dtype not in (None, torch.float32, "float32"):
        raise NotImplementedError(
            f"dtype {dtype!r} is not yet ported in image_enhance_keras_tpu_torch (float32 only)"
        )


class Conv(nn.Module):
    """SAME conv with an HWIO ``kernel`` and a ``bias``, like flax ``nn.Conv``."""

    def __init__(self, in_features: int, features: int, kernel_size: tuple[int, int]):
        super().__init__()
        kh, kw = kernel_size
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.kernel, self.bias)


def make_conv(features: int, kernel_size, *, in_features: int, dtype: Any = None,
              mixed: bool = False) -> Conv:
    """The family's conv; ``mixed`` and non-float32 profiles are not ported yet."""
    check_profile(dtype, mixed)
    return Conv(in_features, features, tuple(kernel_size))


class LightBlock(nn.Module):
    """x + res_scale * conv3(relu(conv3(x)))."""

    def __init__(self, features: int, res_scale: float = 0.1, dtype: Any = None, mixed: bool = False):
        super().__init__()
        self.res_scale = res_scale
        self.conv_a = make_conv(features, (3, 3), in_features=features, dtype=dtype, mixed=mixed)
        self.conv_b = make_conv(features, (3, 3), in_features=features, dtype=dtype, mixed=mixed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.res_scale * self.conv_b(torch.relu(self.conv_a(x)))


class Light53Block(nn.Module):
    """identity_scale*x + res_scale*(conv5(relu(conv3(x))) + conv3(relu(conv5(x))))."""

    def __init__(self, features: int, res_scale: float = 0.1, identity_scale: float = 0.9,
                 dtype: Any = None, mixed: bool = False):
        super().__init__()
        self.res_scale = res_scale
        self.identity_scale = identity_scale
        kw = dict(in_features=features, dtype=dtype, mixed=mixed)
        self.conv_a1 = make_conv(features, (3, 3), **kw)
        self.conv_a2 = make_conv(features, (5, 5), **kw)
        self.conv_b1 = make_conv(features, (5, 5), **kw)
        self.conv_b2 = make_conv(features, (3, 3), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.conv_a2(torch.relu(self.conv_a1(x)))
        b = self.conv_b2(torch.relu(self.conv_b1(x)))
        return self.identity_scale * x + self.res_scale * (a + b)
