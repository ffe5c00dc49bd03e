"""The general traffic generator: a traffic file's parameters and a seed -> the images, in order.

A traffic file (``benchmark/traffic/<name>.json``) holds:

* ``sizes``: the LR image sizes [h, w] the client sends, in a fixed cycle;
* ``pool``: how many distinct images of each size the seed makes;
* ``content``: the generator of their content (``rich``, the procedural
  mix of ``images.py``);
* ``loop``: ``closed`` (one client sends the next image when the previous
  output is back on the host) and ``clients`` (1).

Request i has size ``sizes[i % S]`` and is pool image
``perm[(i // S) % pool]`` of that size, ``perm`` a permutation drawn from
the seed: every seed sends the same sizes in the same order, and the seed
sets only the content and the order within a size.
"""

from __future__ import annotations

import json
import os

import numpy as np

from benchmark import images

__all__ = ["Traffic", "load"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name: str, root: str = _ROOT) -> dict:
    """The traffic file ``benchmark/traffic/<name>.json`` under ``root``."""
    with open(os.path.join(root, "benchmark", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _sub_seed(seed: int, k: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * k) % (1 << 63)


class Traffic:
    """The images of one run: ``image(i)`` is request i."""

    def __init__(self, spec: dict, seed: int):
        if spec.get("loop", "closed") != "closed" or int(spec.get("clients", 1)) != 1:
            raise ValueError("the generator drives one client in a closed loop")
        if spec.get("content", "rich") != "rich":
            raise ValueError(f"unknown content {spec['content']!r}")
        self.sizes = [tuple(int(v) for v in s) for s in spec["sizes"]]
        self.n_pool = int(spec["pool"])
        self.pool = []
        self.perm = []
        for k, (h, w) in enumerate(self.sizes):
            side = max(h, w)
            imgs = images.rich_images(self.n_pool, side, _sub_seed(seed, k))
            self.pool.append([images.crop_center(im, h, w) for im in imgs])
            self.perm.append(np.random.default_rng(_sub_seed(seed, 1000 + k)).permutation(self.n_pool))

    def index(self, i: int) -> tuple[int, int]:
        """(size index, pool index) of request i."""
        s = len(self.sizes)
        k = i % s
        return k, int(self.perm[k][(i // s) % self.n_pool])

    def image(self, i: int) -> np.ndarray:
        k, j = self.index(i)
        return self.pool[k][j]

    @property
    def cycle(self) -> int:
        """Requests after which the sequence repeats."""
        return len(self.sizes) * self.n_pool
