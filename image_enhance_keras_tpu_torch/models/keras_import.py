"""Keras HDF5 checkpoint import (mirror of ``models/keras_import.py``).

Keras 2.x files hold ``f['model_weights'].attrs['layer_names']`` (or the
same at the file root, as ``save_weights`` writes it) and, per layer,
``attrs['weight_names']`` such as ``conv2d_1/kernel:0``.  Conv kernels are
HWIO, the layout of the port's parameter trees, so the import is a rename
by position.  Keras stores ``layer_names`` in topological order: each
Light53 block's branches come as a1, b1, a2, b2 (both branch heads read
the block input), not in creation order a1, a2, b1, b2, and a2 / b1 are
both 5x5, so a creation-order import would swap them without a shape
error.  Files with ``layer_names`` are read in that order; files without
(natural-sorted group names, written by other tools) in creation order.

h5py is imported when a file is read; where it is missing, reading raises
an ImportError that says so.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

from image_enhance_keras_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["keras_conv_order", "load_keras_h5", "import_keras_weights"]


def keras_conv_order(model_name: str, n_body53: int = 16, n_light: int = 6, n_tail53: int = 2,
                     n_head: int = 6, n_mid: int = 20, n_tail: int = 6, n_blocks: int = 32,
                     convention: str = "topo") -> list[tuple[str, ...]]:
    """Parameter paths of every conv layer in the file's stored order.

    ``convention="topo"`` (Keras-written files) interleaves each Light53
    block's branches a1, b1, a2, b2; ``"creation"`` keeps a1, a2, b1, b2.
    Chain graphs (Light blocks, difv4, difvdsr) are the same under both."""
    if convention not in ("topo", "creation"):
        raise ValueError(f"unknown layer-order convention {convention!r}")

    def light53(scope: str) -> list[tuple[str, ...]]:
        names = ("conv_a1", "conv_b1", "conv_a2", "conv_b2") if convention == "topo" else \
            ("conv_a1", "conv_a2", "conv_b1", "conv_b2")
        return [(scope, n) for n in names]

    if model_name in ("didbl", "didbl_subpixel"):
        order: list[tuple[str, ...]] = [("level1",)]
        for i in range(n_body53):
            order += light53(f"body53_{i}")
        for i in range(n_light):
            order += [(f"light_{i}", "conv_a"), (f"light_{i}", "conv_b")]
        if model_name == "didbl_subpixel":
            order += [("subpixel_conv",)]
        for i in range(n_tail53):
            order += light53(f"tail53_{i}")
        return order + [("out",)]
    if model_name == "difv4":
        order = [("level1",)]
        for prefix, n in (("head", n_head), ("mid", n_mid), ("tail", n_tail)):
            for i in range(n):
                order += [(f"{prefix}_{i}", "conv_a"), (f"{prefix}_{i}", "conv_b")]
        return order + [("out",)]
    if model_name == "difvdsr":
        order = [("level1",)]
        for i in range(n_blocks):
            order += [(f"diff_{i}", c) for c in ("conv_a", "conv_b", "conv_c", "conv_d")]
        return order + [("out",)]
    raise KeyError(f"no keras layer order known for model {model_name!r}")


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading Keras .h5 weights needs the h5py package, which is not installed") from e
    return h5py


def load_keras_h5(path: str, return_keras_written: bool = False):
    """(layer_name, kernel, bias) of every conv layer (4-D kernel) in the
    file's stored order; with ``return_keras_written`` also whether the file
    has ``layer_names`` (stored order = Keras's topological order)."""
    h5py = _h5py()

    def natural(name: str):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]

    def text(n):
        return n.decode() if isinstance(n, bytes) else n

    out = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        keras_written = "layer_names" in root.attrs
        if keras_written:
            layer_names = [text(n) for n in root.attrs["layer_names"]]
        else:
            layer_names = sorted(root.keys(), key=natural)
            log.warning("%s has no 'layer_names' attribute (not written by Keras?); using natural-sorted "
                        "group order: verify the import against recorded activations", path)
        for name in layer_names:
            g = root[name]
            kernel = bias = None
            for wn in (text(n) for n in g.attrs.get("weight_names", [])):
                arr = np.asarray(g[wn])
                if "kernel" in wn:
                    kernel = arr
                elif "bias" in wn:
                    bias = arr
            if kernel is not None and kernel.ndim == 4:
                out.append((name, kernel, bias))
    return (out, keras_written) if return_keras_written else out


def import_keras_weights(path: str, model_name: str, params: Any, **counts) -> dict:
    """A copy of the nested-dict tree ``params`` (numpy arrays or tensors)
    with every conv's kernel and bias replaced from the h5 file, matched by
    position against :func:`keras_conv_order` (``counts``: block counts of
    reduced models, or ``convention=`` to force one; by default it follows
    the file).  The replaced leaves are float32 numpy arrays.  Raises on a
    count or shape mismatch."""
    convs, keras_written = load_keras_h5(path, return_keras_written=True)
    counts.setdefault("convention", "topo" if keras_written else "creation")
    log.info("importing %s with the %s layer-order convention", path, counts["convention"])
    order = keras_conv_order(model_name, **counts)
    if len(convs) != len(order):
        raise ValueError(f"{path}: has {len(convs)} conv layers, model {model_name!r} expects {len(order)}")

    def plain(d):
        return {k: plain(v) for k, v in d.items()} if hasattr(d, "items") else d

    tree = plain(params)
    for (_, kernel, bias), keys in zip(convs, order):
        node = tree
        for k in keys:
            node = node[k]
        if tuple(kernel.shape) != tuple(node["kernel"].shape):
            raise ValueError(f"kernel shape mismatch at {'/'.join(keys)}: file {kernel.shape} vs model "
                             f"{tuple(node['kernel'].shape)}")
        node["kernel"] = np.asarray(kernel, np.float32)
        if bias is not None:
            node["bias"] = np.asarray(bias, np.float32)
    return tree
