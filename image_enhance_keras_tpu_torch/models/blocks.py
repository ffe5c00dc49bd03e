"""Residual blocks of the didbl generator (mirror of ``models/blocks.py``).

Submodule and parameter names follow the flax tree (``conv_a1/kernel``), so
``models.weights.load_params`` maps the npz checkpoints one to one.
Activations are NHWC and kernels HWIO, as in the JAX package.

Precision profiles: float32, and bf16 (``dtype=torch.bfloat16`` or
``"bfloat16"``), which runs as flax ``nn.Conv(dtype=bf16)`` does: x, kernel
and bias cast to bf16, the conv emitting bf16, the bias added in bf16, and
the blocks' scale-and-add combines in bf16 with the scales' bf16 values
(0.9 -> 0.8984375, 0.1 -> 0.10009765625).  ``mixed=True`` with bf16 is the
JAX package's ``_CONV_F32ACC`` conv: x, kernel and bias rounded to bf16,
the conv of those values in float32 emitting float32, the rounded bias
added in float32; the combines then run in float32 with float32 scales.
Parameters stay float32.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from image_enhance_keras_tpu_torch.ops.conv import conv2d_nhwc

__all__ = ["Conv", "LightBlock", "Light53Block", "DiffBlock", "act", "make_conv", "profile_dtype", "scale"]

#: the precision profiles this port runs, by the names the JAX package takes
_PROFILES = {None: torch.float32, torch.float32: torch.float32, "float32": torch.float32,
             torch.bfloat16: torch.bfloat16, "bfloat16": torch.bfloat16}


def profile_dtype(dtype: Any) -> torch.dtype:
    """The conv dtype of a profile (None -> float32); raises for a dtype that
    is no profile here or in the JAX package (float16, for one)."""
    try:
        return _PROFILES[dtype]
    except (KeyError, TypeError):
        raise NotImplementedError(
            f"dtype {dtype!r} is not a profile of image_enhance_keras_tpu_torch or of the JAX package: "
            f"both serve float32 and bfloat16 (the mixed profiles through mixed=)"
        ) from None


def scale(v: float, like: torch.Tensor) -> float | torch.Tensor:
    """A residual scale for an activation like ``like``: the Python float for
    float32, its bf16 value as a 0-d tensor for bf16 (``jnp.asarray(v, h.dtype)``)."""
    return v if like.dtype == torch.float32 else torch.tensor(v, dtype=like.dtype)


def _promoted(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x in the dtype JAX gives ``asarray(v, h.dtype) * x`` (a bf16 x beside a
    float32 h, as in the first mixed-tail block, is promoted; torch would not
    promote it for a 0-d scale)."""
    return x.to(torch.promote_types(x.dtype, h.dtype))


class Conv(nn.Module):
    """SAME conv with an HWIO ``kernel`` and a ``bias``, like flax ``nn.Conv``."""

    def __init__(self, in_features: int, features: int, kernel_size: tuple[int, int],
                 dtype: torch.dtype = torch.float32, mixed: bool = False):
        super().__init__()
        kh, kw = kernel_size
        self.dtype = dtype
        #: bf16-rounded operands, float32 conv and emission (no-op for float32)
        self.mixed = mixed and dtype != torch.float32
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return conv2d_nhwc(x, self.kernel, self.bias)
        dt = self.dtype
        if self.mixed:
            f32 = torch.float32
            return conv2d_nhwc(x.to(dt).to(f32), self.kernel.to(dt).to(f32)) + self.bias.to(dt).to(f32)
        return conv2d_nhwc(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


def make_conv(features: int, kernel_size, *, in_features: int, dtype: Any = None,
              mixed: bool = False) -> Conv:
    """The family's conv in the profile's dtype; ``mixed``: its dots on that
    dtype's values, emitting float32."""
    return Conv(in_features, features, tuple(kernel_size), profile_dtype(dtype), mixed)


def act(t: torch.Tensor, leaky_slope: float | None) -> torch.Tensor:
    """relu, or flax's leaky relu ``where(t >= 0, t, slope * t)`` in t's dtype
    (the slope rounded to it, as JAX's weakly typed constant is)."""
    if leaky_slope is None:
        return torch.relu(t)
    return torch.where(t >= 0, t, scale(leaky_slope, t) * t)


class LightBlock(nn.Module):
    """x + res_scale * conv3(act(conv3(x))); act is relu, or leaky relu with ``leaky_slope``."""

    def __init__(self, features: int, res_scale: float = 0.1, leaky_slope: float | None = None,
                 dtype: Any = None, mixed: bool = False):
        super().__init__()
        self.res_scale = res_scale
        self.leaky_slope = leaky_slope
        self.conv_a = make_conv(features, (3, 3), in_features=features, dtype=dtype, mixed=mixed)
        self.conv_b = make_conv(features, (3, 3), in_features=features, dtype=dtype, mixed=mixed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_b(act(self.conv_a(x), self.leaky_slope))
        return _promoted(x, h) + scale(self.res_scale, h) * h


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
        h = a + b
        return scale(self.identity_scale, h) * _promoted(x, h) + scale(self.res_scale, h) * h


class DiffBlock(nn.Module):
    """The "difference" block of difvdsr:

    t = conv_b(relu(conv_a(x))); d = t - x; u = conv_d(act(conv_c(d)));
    out = x + res_scale * (d + u + t), or x + res_scale * (u + t) without ``three_way``.
    """

    def __init__(self, features: int, res_scale: float = 0.1, leaky_slope: float | None = 0.2,
                 three_way: bool = True, dtype: Any = None, mixed: bool = False):
        super().__init__()
        self.res_scale = res_scale
        self.leaky_slope = leaky_slope
        self.three_way = three_way
        kw = dict(in_features=features, dtype=dtype, mixed=mixed)
        self.conv_a = make_conv(features, (3, 3), **kw)
        self.conv_b = make_conv(features, (3, 3), **kw)
        self.conv_c = make_conv(features, (3, 3), **kw)
        self.conv_d = make_conv(features, (3, 3), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.conv_b(torch.relu(self.conv_a(x)))
        d = t - _promoted(x, t)
        u = self.conv_d(act(self.conv_c(d), self.leaky_slope))
        s = d + u + t if self.three_way else u + t
        return _promoted(x, s) + scale(self.res_scale, s) * s
