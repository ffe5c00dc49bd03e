"""Random weights from the seed, made on the device in one draw.

The rule is the port's published one (``init_params``): every kernel
N(0, gain^2 / fan_in), fan_in = kh * kw * cin of its HWIO shape, every
bias zero.  The numbers come from one ``torch.randn`` on a generator of the
run's device seeded with the run's seed, cut into the leaves in the order
of the configuration's parameter names, so the same seed on the same
device gives the same weights.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_weights"]


def make_weights(shapes: dict[str, tuple[int, ...]], init: dict, seed: int, device) -> dict:
    """{"a/b/kernel": shape} -> the nested float32 tree {"a": {"b": {"kernel": t}}} on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    kernels = [(n, s) for n, s in shapes.items() if n.endswith("kernel")]
    flat = torch.randn(sum(math.prod(s) for _, s in kernels), generator=gen, device=device, dtype=torch.float32)
    gain = float(init.get("gain", 1.0))
    tree: dict = {}
    off = 0
    for name, shape in shapes.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        if name.endswith("kernel"):
            n = math.prod(shape)
            fan_in = int(shape[0]) * int(shape[1]) * int(shape[2])
            node[leaf] = (flat[off : off + n].reshape(shape) * (gain / math.sqrt(fan_in))).contiguous()
            off += n
        else:
            node[leaf] = torch.full(shape, float(init.get("bias", 0.0)), device=device, dtype=torch.float32)
    return tree
