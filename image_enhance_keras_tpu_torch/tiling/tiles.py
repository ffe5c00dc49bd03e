"""Overlapped tiling as separable gathers (mirror of ``tiling/tiles.py``).

The reference zero-pads the image, extracts overlapping tiles (96 at step
64), upscales each and pastes the x4 outputs back with an 8-px crop, later
tiles overwriting earlier ones in column-major order.  Both directions are
separable gathers: the index vectors are built in numpy, the gathers run in
torch on the image's device.

The shifted grid of split mode's 2-D tiled tail (``shift_grid_axis`` and
the helpers after it) covers [0, total) with uniform tiles of T = t +
2*halo whose owned rows [k, k+len) partition it at stride t; owned rows
sit at least ``halo`` from a tile border that is not the image's, so each
tile's SAME convs and clamped x4 see what the whole frame would.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "TilePlan",
    "plan_tiles",
    "pad_to_plan",
    "extract_tiles",
    "stitch_tiles",
    "crop_output",
    "shift_grid_axis",
    "shifted_extract_indices",
    "shifted_stitch_indices",
    "gather_tiles_2d",
    "scatter_tiles_2d",
]


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Tile geometry for one input size."""

    orig_h: int
    orig_w: int
    padded_h: int
    padded_w: int
    patch: int
    step: int
    cnt_h: int
    cnt_w: int
    scale: int
    crop: int

    @property
    def n_tiles(self) -> int:
        return self.cnt_h * self.cnt_w

    @property
    def out_h(self) -> int:
        return self.orig_h * self.scale

    @property
    def out_w(self) -> int:
        return self.orig_w * self.scale


def _count_positions(padded: int, patch: int, step: int) -> int:
    # positions w in {0, step, ...} with w < padded - patch (img_utils.py:622-628)
    limit = padded - patch
    if limit <= 0:
        return 0
    return (limit - 1) // step + 1


def plan_tiles(height: int, width: int, patch: int = 96, step: int = 64, scale: int = 4,
               crop: int = 8) -> TilePlan:
    """The reference padding arithmetic: pad by ``patch``, then round BOTH dims
    up to ``(dim // step + 1) * step`` if either is not a multiple of ``step``."""
    h1, w1 = height + patch, width + patch
    if h1 % step != 0 or w1 % step != 0:
        h1 = (h1 // step + 1) * step
        w1 = (w1 // step + 1) * step
    return TilePlan(
        orig_h=height,
        orig_w=width,
        padded_h=h1,
        padded_w=w1,
        patch=patch,
        step=step,
        cnt_h=_count_positions(h1, patch, step),
        cnt_w=_count_positions(w1, patch, step),
        scale=scale,
        crop=crop,
    )


def pad_to_plan(img: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Zero-pad an (H, W, C) image bottom/right to the plan's padded size."""
    ph = plan.padded_h - img.shape[0]
    pw = plan.padded_w - img.shape[1]
    return F.pad(img, (0, 0, 0, pw, 0, ph))


@functools.lru_cache(maxsize=None)
def _extract_indices(plan: TilePlan) -> tuple[np.ndarray, np.ndarray]:
    p, s = plan.patch, plan.step
    rows = (np.arange(plan.cnt_h)[:, None] * s + np.arange(p)[None, :]).reshape(-1)
    cols = (np.arange(plan.cnt_w)[:, None] * s + np.arange(p)[None, :]).reshape(-1)
    return rows.astype(np.int64), cols.astype(np.int64)


def extract_tiles(img: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(padded_h, padded_w, C) -> (N, P, P, C) tiles, column-major tile order."""
    rows, cols = (torch.from_numpy(a).to(img.device) for a in _extract_indices(plan))
    p, c = plan.patch, img.shape[-1]
    g = img.index_select(0, rows).index_select(1, cols)
    g = g.reshape(plan.cnt_h, p, plan.cnt_w, p, c)
    return g.permute(2, 0, 1, 3, 4).reshape(plan.n_tiles, p, p, c)


@functools.lru_cache(maxsize=None)
def _stitch_indices(plan: TilePlan) -> tuple[np.ndarray, np.ndarray]:
    ps = plan.patch * plan.scale
    ss = plan.step * plan.scale
    cr = plan.crop

    def axis_index(n_out: int, cnt: int) -> np.ndarray:
        y = np.arange(n_out)
        own = np.clip((y - cr) // ss, 0, cnt - 1)
        intra = np.clip(y - own * ss, 0, ps - 1)
        return (own * ps + intra).astype(np.int64)

    return (
        axis_index(plan.padded_h * plan.scale, plan.cnt_h),
        axis_index(plan.padded_w * plan.scale, plan.cnt_w),
    )


def stitch_tiles(tiles: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(N, P*scale, P*scale, C) -> (padded_h*scale, padded_w*scale, C): the
    closed form of the reference's overwrite-order crop-paste."""
    ps = plan.patch * plan.scale
    c = tiles.shape[-1]
    t = tiles.reshape(plan.cnt_w, plan.cnt_h, ps, ps, c)
    t = t.permute(1, 2, 0, 3, 4).reshape(plan.cnt_h * ps, plan.cnt_w * ps, c)
    rows, cols = (torch.from_numpy(a).to(tiles.device) for a in _stitch_indices(plan))
    return t.index_select(0, rows).index_select(1, cols)


def crop_output(canvas: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Final crop to (orig_h*scale, orig_w*scale)."""
    return canvas[: plan.out_h, : plan.out_w]


@functools.lru_cache(maxsize=None)
def shift_grid_axis(total: int, t: int, halo: int) -> tuple[int, tuple[int, ...], tuple[tuple[int, int], ...]]:
    """Uniform shifted-tile cover of [0, total): (T, starts, keeps), tiles
    [start, start+T), keeps[k] = (offset inside the tile, length) of the rows
    tile k owns."""
    T = min(t + 2 * halo, total)
    starts, keeps = [], []
    for k in range(0, total, t):
        length = min(t, total - k)
        start = min(max(k - halo, 0), total - T)
        starts.append(start)
        keeps.append((k - start, length))
    return T, tuple(starts), tuple(keeps)


@functools.lru_cache(maxsize=None)
def shifted_extract_indices(total: int, t: int, halo: int) -> np.ndarray:
    """(n*T,) gather index vector: row j*T+i reads source row starts[j]+i."""
    T, starts, _ = shift_grid_axis(total, t, halo)
    idx = (np.asarray(starts)[:, None] + np.arange(T)[None, :]).reshape(-1)
    return idx.astype(np.int64)


@functools.lru_cache(maxsize=None)
def shifted_stitch_indices(total: int, t: int, halo: int, scale: int) -> np.ndarray:
    """(total*scale,) gather index into the (n*T*scale,) tile-major layout:
    output row y is owned by tile i = y // (t*scale), at keeps[i].offset*scale
    + (y - i*t*scale) inside it."""
    T, starts, keeps = shift_grid_axis(total, t, halo)
    y = np.arange(total * scale)
    i = np.minimum(y // (t * scale), len(starts) - 1)
    offs = np.asarray([k[0] for k in keeps])
    idx = i * (T * scale) + offs[i] * scale + (y - i * t * scale)
    return idx.astype(np.int64)


def gather_tiles_2d(x: torch.Tensor, ex_r: torch.Tensor, ex_c: torch.Tensor, n_r: int, n_c: int,
                    T_r: int, T_c: int) -> torch.Tensor:
    """(H, W, C) -> (n_r*n_c, T_r, T_c, C) shifted tiles, row-major tile order,
    as two separable gathers (contiguous)."""
    c = x.shape[-1]
    y = x.index_select(0, ex_r).index_select(1, ex_c)
    y = y.reshape(n_r, T_r, n_c, T_c, c)
    return y.permute(0, 2, 1, 3, 4).reshape(n_r * n_c, T_r, T_c, c)


def scatter_tiles_2d(y: torch.Tensor, st_r: torch.Tensor, st_c: torch.Tensor, n_r: int, n_c: int,
                     T_r: int, T_c: int, scale: int = 1) -> torch.Tensor:
    """(n_r*n_c, T_r*scale, T_c*scale, C) -> (H*scale, W*scale, C): the
    owned-crop stitch, inverse of :func:`gather_tiles_2d` over the owned
    cores (``st_*`` from :func:`shifted_stitch_indices`)."""
    c = y.shape[-1]
    yy = y.reshape(n_r, n_c, T_r * scale, T_c * scale, c)
    yy = yy.permute(0, 2, 1, 3, 4).reshape(n_r * T_r * scale, n_c * T_c * scale, c)
    return yy.index_select(0, st_r).index_select(1, st_c)
