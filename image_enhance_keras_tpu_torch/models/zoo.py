"""Model registry (mirror of ``models/zoo.py``); this slice ports ``didbl`` only."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble

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
}


def get_model(name: str, dtype=None, **kw) -> tuple[nn.Module, ModelSpec]:
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"model {name!r} is not yet ported in image_enhance_keras_tpu_torch; "
            f"available: {sorted(MODEL_REGISTRY)}"
        )
    spec = MODEL_REGISTRY[name]
    return spec.make(dtype=dtype, **kw), spec


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from ``seed``: kernels N(0, 1/fan_in), biases zero.

    Same scale as flax's lecun_normal, not the same numbers (the generators
    differ); random weights are for smoke runs only.
    """
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("kernel"):
            fan_in = p.shape[0] * p.shape[1] * p.shape[2]
            w = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
            p.copy_(w.to(p.device))
        else:
            p.zero_()
    return model
