"""Operations and bytes of a forward, from a configuration's ``layers``, and the card's peaks.

A configuration file lists its layers: convolutions (kernel ``k``, ``cin``,
``cout``) and upsamples (``factor``, channels ``c``), each at a linear
``scale`` over the forward's input and repeated ``count`` times; a width or
a count may name a key of ``model_kwargs``.  ``precision`` says, for each of
the program's forwards, in which precision each ``group`` of layers runs.
A convolution does 2 k^2 cin cout operations an output pixel; it reads its
input and weights once and writes its output once.  An upsample does no
counted operation; it reads its input once and writes f^2 times as much.
"""

from __future__ import annotations

import json
import os

from benchmark.reference.common import plan_tiles

__all__ = ["load_peaks", "layers", "image_work", "forward_calls", "forward_pixels", "mflop_per_lr_pixel"]

_HERE = os.path.dirname(os.path.abspath(__file__))


def load_peaks() -> dict:
    with open(os.path.join(_HERE, "peaks.json")) as f:
        return json.load(f)


def _val(v, kwargs: dict) -> int:
    return int(kwargs[v]) if isinstance(v, str) else int(v)


def layers(cfg: dict, forward: str) -> list[dict]:
    """Each layer with its widths and count resolved and its precision under ``forward``."""
    kw = cfg["model_kwargs"]
    prec = cfg["precision"][forward]
    out = []
    for lay in cfg["layers"]:
        d = {k: (_val(v, kw) if k in ("k", "cin", "cout", "c", "factor", "scale", "count") else v)
             for k, v in lay.items()}
        d["precision"] = prec[lay["group"]]
        out.append(d)
    return out


def image_work(cfg: dict, forward: str, lr_pixels: int, peaks: dict) -> dict:
    """For one forward over ``lr_pixels`` input pixels: operations by
    precision, the seconds they take at the peaks (``ops_s``), and the
    roofline's least time of every layer, max(ops / peak, bytes / bandwidth),
    summed (``bound_s``)."""
    ops_by: dict[str, float] = {}
    ops_s = bound_s = 0.0
    bw = float(peaks["bytes_per_s"])
    for lay in layers(cfg, forward):
        p = lay["precision"]
        e = int(peaks["element_bytes"][p])
        px = lr_pixels * lay["scale"] ** 2
        if lay["op"] == "conv":
            ops = 2.0 * lay["k"] ** 2 * lay["cin"] * lay["cout"] * px
            nbytes = e * px * (lay["cin"] + lay["cout"]) + e * lay["k"] ** 2 * lay["cin"] * lay["cout"]
        else:
            ops = 0.0
            nbytes = e * px * lay["c"] * (1 + lay["factor"] ** 2)
        ops *= lay["count"]
        nbytes *= lay["count"]
        t_ops = ops / float(peaks["ops_per_s"][p])
        ops_by[p] = ops_by.get(p, 0.0) + ops
        ops_s += t_ops
        bound_s += max(t_ops, nbytes / bw)
    return {"ops": ops_by, "ops_s": ops_s, "bound_s": bound_s}


def forward_calls(h: int, w: int, mode: str, patch: int = 96, step: int = 64, crop: int = 8, scale: int = 4,
                  tile_chunk: int = 16) -> list[int]:
    """Input pixels of each forward call for one (h, w) image: the frame
    (``fast``), or the tiles of the reference's plan in chunks of the engine's
    ``tile_chunk`` (scaled from 96-px tiles by area), a remainder call last (``patch``)."""
    if mode == "fast":
        return [h * w]
    if mode == "patch":
        n = plan_tiles(h, w, patch, step, scale, crop).n_tiles
        chunk = min(max(1, tile_chunk * 96 * 96 // (patch * patch)), n)
        return [chunk * patch * patch] * (n // chunk) + ([(n % chunk) * patch * patch] if n % chunk else [])
    raise ValueError(f"no forward calls for mode {mode!r}")


def forward_pixels(h: int, w: int, mode: str, **geometry) -> int:
    """Input pixels the forwards see for one (h, w) image."""
    return sum(forward_calls(h, w, mode, **geometry))


def mflop_per_lr_pixel(cfg: dict, forward: str = "xla") -> float:
    """Convolution operations per input pixel, in millions."""
    return sum(v for v in image_work(cfg, forward, 1, load_peaks())["ops"].values()) / 1e6
