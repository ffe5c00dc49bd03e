"""Model registry (mirror of ``models/zoo.py``): the five zoo entries."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.difv4 import Difvdsr4
from image_enhance_keras_tpu_torch.models.difvdsr import Difvdsr
from image_enhance_keras_tpu_torch.ops.pixel_shuffle import icnr_init

__all__ = ["ModelSpec", "MODEL_REGISTRY", "get_model", "init_params", "resolve_default_weights"]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static description of a zoo entry."""

    name: str
    make: Callable[..., nn.Module]
    net_scale: int  # output/input spatial ratio of the network itself
    pre_upscaled_input: bool  # difvdsr operates on an already-upscaled image
    description: str
    #: repo-relative demo checkpoint (.npz) or None
    default_weights: str | None
    #: evaluated by the divisible-shape driver (none of the shipped models)
    requires_divisible_shape: bool = False


def resolve_default_weights(spec: ModelSpec) -> str | None:
    """Path of the family's committed demo checkpoint (CWD, then this checkout), or None."""
    from image_enhance_keras_tpu_torch.utils.paths import find_repo_asset

    return find_repo_asset(spec.default_weights)


MODEL_REGISTRY: dict[str, ModelSpec] = {
    "didbl": ModelSpec(
        "didbl",
        lambda dtype=None, **kw: DifvdsrDouble(dtype=dtype, **kw),
        net_scale=4,
        pre_upscaled_input=False,
        description="DifvdsrDouble x4 (reference models.py:1146-1270)",
        default_weights="weights_Double/didbl_set5demo.npz",
    ),
    "didbl_subpixel": ModelSpec(
        "didbl_subpixel",
        lambda dtype=None, **kw: DifvdsrDouble(upsampler="subpixel", dtype=dtype, **kw),
        net_scale=4,
        pre_upscaled_input=False,
        description="didbl with depth_to_space head (advanced.py/keras_subpixel.py)",
        default_weights="weights_demo_didbl_subpixel/didbl_subpixel_set5demo.npz",
    ),
    "difv4": ModelSpec(
        "difv4",
        lambda dtype=None, **kw: Difvdsr4(dtype=dtype, **kw),
        net_scale=4,
        pre_upscaled_input=False,
        description="Difvdsr4 progressive 2x+2x (reference models.py:992-1142)",
        default_weights="weights_demo_difv4/difv4_set5demo.npz",
    ),
    "difv4_x2": ModelSpec(
        "difv4_x2",
        lambda dtype=None, **kw: Difvdsr4(dtype=dtype, scale=2, **kw),
        net_scale=2,
        pre_upscaled_input=False,
        description="Difvdsr4 single-2x variant (the reference's x2 dev-note configs, models.py:1061-1069)",
        default_weights=None,
    ),
    "difvdsr": ModelSpec(
        "difvdsr",
        lambda dtype=None, **kw: Difvdsr(dtype=dtype, **kw),
        net_scale=1,
        pre_upscaled_input=True,
        description="Difvdsr refiner on pre-upscaled input (reference models.py:1274-1357)",
        default_weights="weights_demo_difvdsr/difvdsr_set5demo.npz",
    ),
}


def get_model(name: str, dtype=None, **kw) -> tuple[nn.Module, ModelSpec]:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    spec = MODEL_REGISTRY[name]
    return spec.make(dtype=dtype, **kw), spec


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from ``seed``: kernels N(0, 1/fan_in), biases zero; the
    subpixel head's kernel by ICNR (``ops/pixel_shuffle.icnr_init``).

    Same scale as flax's lecun_normal, not the same numbers (the generators
    differ); random weights are for smoke runs only.
    """
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for name, p in model.named_parameters():
        if name == "subpixel_conv.kernel":
            p.copy_(icnr_init(tuple(p.shape), scale=model.scale, order="dcr", generator=gen).to(p.device))
        elif name.endswith("kernel"):
            fan_in = p.shape[0] * p.shape[1] * p.shape[2]
            w = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
            p.copy_(w.to(p.device))
        else:
            p.zero_()
    return model
