"""Parameter trees between the JAX package's layout and the port.

A parameter tree is a nested dict keyed like the flax tree and the npz
checkpoints (``level1/kernel``, ``body53_0/conv_a1/bias``, ...); kernels stay
HWIO.  ``params_from_numpy`` turns a tree of numpy arrays (or tensors) into
float32 tensors on a device; ``load_params`` copies a tree into a module
whose submodules carry the same names, and ``params_of_module`` reads one
back out (sharing the module's storage).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_numpy", "flatten_params", "load_params", "params_of_module"]


def params_from_numpy(tree: Any, device: str | torch.device = "cpu") -> Any:
    """Nested dict of arrays -> the same dict of tensors on ``device``.

    Float leaves come back float32 (the committed demo checkpoints store
    fp16); int8 leaves stay int8, so a quantized tree of the JAX package
    (``quantize_didbl_params``: "q"/"qf" int8 codes beside float32 "s",
    "sf", "bias", "act", "actc") carries over as the port's.
    """
    if hasattr(tree, "items"):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        dtype = torch.int8 if tree.dtype == torch.int8 else torch.float32
        return tree.detach().to(device=device, dtype=dtype).contiguous()
    arr = np.asarray(tree)
    arr = arr if arr.dtype == np.int8 else arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device)


def flatten_params(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{"a/b/kernel": leaf} for a nested dict."""
    if not hasattr(tree, "items"):
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in tree.items():
        out.update(flatten_params(v, f"{prefix}/{k}" if prefix else k))
    return out


def load_params(module: nn.Module, tree: Any) -> None:
    """Copy a parameter tree (nested, or flat by slash-joined path) into
    ``module``; every leaf must match by name and shape."""
    device = next(module.parameters()).device
    flat = flatten_params(params_from_numpy(tree, device))
    state = {k.replace("/", "."): v for k, v in flat.items()}
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise ValueError(
            f"parameter tree does not match {type(module).__name__}: "
            f"missing {missing[:5]}, unexpected {unexpected[:5]}"
        )
    for k, v in state.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != module's {tuple(own[k].shape)}")
    module.load_state_dict(state, strict=True)


def params_of_module(module: nn.Module) -> dict[str, Any]:
    """The module's parameters as a nested dict (no copies)."""
    out: dict[str, Any] = {}
    for name, p in module.named_parameters():
        node = out
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = p.detach()
    return out
