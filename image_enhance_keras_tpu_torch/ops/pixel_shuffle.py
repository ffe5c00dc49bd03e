"""Pixel shuffle (depth-to-space) as reshape and permute (mirror of ``ops/pixel_shuffle.py``).

Two channel orders, as in the JAX package:

* ``"dcr"``: TF ``tf.depth_to_space``, channel ``(dy*r + dx)*C + c``;
* ``"keras_ref"``: the reference's phase shift, channel ``c*r*r + dx*r + dy``.

``icnr_init`` draws an ICNR kernel (every r*r output-channel group shares
one base filter, so conv + depth_to_space at init is a nearest-neighbour
resize followed by a conv); it has JAX's structure, not its numbers.
"""

from __future__ import annotations

import math

import torch

__all__ = ["depth_to_space", "space_to_depth", "icnr_init"]


def icnr_init(shape: tuple[int, int, int, int], scale: int = 4, order: str = "dcr",
              generator: torch.Generator | None = None) -> torch.Tensor:
    """An HWIO kernel of ``shape`` whose output channels are laid out for
    :func:`depth_to_space` with ``order``; the base filter is N(0, 1/fan_in)."""
    kh, kw, cin, cout = (int(s) for s in shape)
    r2 = scale * scale
    if cout % r2 != 0:
        raise ValueError(f"output channels {cout} not divisible by scale^2={r2}")
    c = cout // r2
    base = torch.randn((kh, kw, cin, c), generator=generator) / math.sqrt(kh * kw * cin)
    if order == "dcr":
        k = base[:, :, :, None, :].expand(kh, kw, cin, r2, c)
    elif order == "keras_ref":
        k = base[:, :, :, :, None].expand(kh, kw, cin, c, r2)
    else:
        raise ValueError(f"unknown order {order!r}")
    return k.reshape(kh, kw, cin, cout).contiguous()


def depth_to_space(x: torch.Tensor, r: int, order: str = "dcr") -> torch.Tensor:
    """(B, H, W, r*r*C) -> (B, H*r, W*r, C); also takes an unbatched (H, W, r*r*C)."""
    unbatched = x.dim() == 3
    if unbatched:
        x = x[None]
    b, h, w, ch = x.shape
    if ch % (r * r) != 0:
        raise ValueError(f"channels {ch} not divisible by r^2={r * r}")
    c = ch // (r * r)
    if order == "dcr":
        y = x.reshape(b, h, w, r, r, c).permute(0, 1, 3, 2, 4, 5)  # (B,H,dy,W,dx,c)
    elif order == "keras_ref":
        y = x.reshape(b, h, w, c, r, r).permute(0, 1, 5, 2, 4, 3)  # (B,H,dy,W,dx,c)
    else:
        raise ValueError(f"unknown order {order!r}")
    y = y.reshape(b, h * r, w * r, c)
    return y[0] if unbatched else y


def space_to_depth(x: torch.Tensor, r: int, order: str = "dcr") -> torch.Tensor:
    """Inverse of :func:`depth_to_space`."""
    unbatched = x.dim() == 3
    if unbatched:
        x = x[None]
    b, hr, wr, c = x.shape
    if hr % r or wr % r:
        raise ValueError("spatial dims not divisible by r")
    h, w = hr // r, wr // r
    y = x.reshape(b, h, r, w, r, c)  # (B,H,dy,W,dx,c)
    if order == "dcr":
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, r * r * c)
    elif order == "keras_ref":
        y = y.permute(0, 1, 3, 5, 4, 2).reshape(b, h, w, r * r * c)
    else:
        raise ValueError(f"unknown order {order!r}")
    return y[0] if unbatched else y
