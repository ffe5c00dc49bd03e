"""Data parallelism over a mesh: tiled and whole-frame inference, and the
train and eval steps (mirror of ``parallel/data_parallel.py``).

One process drives every device of its mesh: a batch (or a frame's rows)
is cut into one shard a device, each device runs its shard with its own
replica of the weights, and the results are gathered once on the mesh's
first device.  Nothing in the loop over the shards waits for a device, so
with several cards their launches queue concurrently.

  * patch, video and split mode's 2-D tiled tail: the single-device
    program's chunks of tiles (or frames) go to the devices in turn, whole,
    so that every call has the batch it has on one device: a library
    convolution (cuDNN) picks its algorithm, and so its order of summation,
    by the batch, and a shard of another size moves a uint8 level here and
    there (ROADMAP.md §3).  Patch-average (one call of every tile on one
    device) pads its tile batch to a device multiple and shards it, as
    JAX does; on the card that still gives one device's bytes at
    ``compat``'s geometries (``chip_smoke.py`` phase 8a);
  * fast, frame and split: a frame has no batch axis, so its rows are cut
    into bands (``parallel/bands.py``), with a halo exchange before each
    block; split mode's tail stripes are cut into bands of columns.
    Different array extents may let a library convolution sum in another
    order, so these hold to the single-device output within one uint8 level.
"""

from __future__ import annotations

import copy
from typing import Any, Callable

import numpy as np
import torch

from image_enhance_keras_tpu_torch.engine import SuperResolver
from image_enhance_keras_tpu_torch.ops.color import im2double
from image_enhance_keras_tpu_torch.parallel.bands import Weights, forward_stages, run_bands, split_sizes
from image_enhance_keras_tpu_torch.parallel.mesh import Mesh
from image_enhance_keras_tpu_torch.tiling.tiles import crop_output, extract_tiles, pad_to_plan, stitch_tiles
from image_enhance_keras_tpu_torch.utils.logging import get_logger

__all__ = ["shard_train_step", "shard_eval_step", "shard_batch", "ShardedResolver", "tree_to"]

log = get_logger(__name__)


def tree_to(tree: Any, device: torch.device) -> Any:
    """A nested dict of tensors copied to ``device`` (fresh tensors: kernel
    weight packs cached on them are that device's own)."""
    if hasattr(tree, "items"):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _local(mesh: Mesh) -> list[torch.device]:
    devs = mesh.local_devices()
    if not devs:
        raise ValueError("the mesh has no entry of this process")
    return devs


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """A batch cut along axis 0 into one shard per local mesh entry, each on
    its device; the batch size must be a multiple of the entries."""
    devs = _local(mesh)
    n = int(batch.shape[0])
    if n % len(devs):
        raise ValueError(f"a batch of {n} does not divide over the mesh's {len(devs)} devices")
    per = n // len(devs)
    return [batch[i * per : (i + 1) * per].to(d) for i, d in enumerate(devs)]


def shard_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """A step of ``train.trainer.make_train_step`` rebuilt as the
    data-parallel step over ``mesh`` (``make_train_step(mesh=...)``): the
    batch sharded, the gradient of the global-batch mean combined on the
    first device, the state replicated after the update."""
    from image_enhance_keras_tpu_torch.train.trainer import make_train_step

    return make_train_step(**{**step_fn.config, "mesh": mesh})


def shard_eval_step(eval_fn: Callable, mesh: Mesh) -> Callable:
    """``make_eval_step(...)`` as a data-parallel step over ``mesh``."""
    from image_enhance_keras_tpu_torch.train.trainer import make_eval_step

    return make_eval_step(**{**eval_fn.config, "mesh": mesh})


class ShardedResolver(SuperResolver):
    """:class:`SuperResolver` with every mode sharded over a mesh's devices.

    ``mesh`` (or ``n_devices``: ``make_mesh(n_devices)`` on CUDA, N CPU
    entries when ``device="cpu"``).  Batch-sharded modes (patch, video,
    patch-average) equal the single-device program byte for byte (on CUDA,
    patch-average only where the library convolutions sum a shard as they
    sum the whole batch);
    spatially sharded modes (fast, frame, split, split2d's body) equal it
    within one uint8 level, and byte for byte where the per-band arithmetic
    sums as the whole frame's does (the hand-written kernels, and the
    per-sample abs-max of the int8 dynamic tail, reduced over the bands).
    The weights (int8 ones quantized once, on the first device, and those
    of internal learning) are replicated to every device of the mesh.
    """

    def __init__(self, *args, mesh: Mesh | None = None, n_devices: int | None = None, **kw):
        from image_enhance_keras_tpu_torch.parallel.mesh import make_mesh

        if mesh is None:
            dev = torch.device(kw.get("device", "cuda"))
            mesh = make_mesh(n_devices, devices=[dev] * int(n_devices or 1) if dev.type == "cpu" else None)
        self.mesh = mesh
        self.devices = _local(mesh)
        self.n_devices = len(self.devices)
        self._placed: dict = {}
        self._modules: dict = {}
        self._frames_a_call = 1
        kw["device"] = self.devices[0]
        super().__init__(*args, **kw)

    # -- weights on every device ----------------------------------------------------
    def _weights_sharding(self) -> list[torch.device]:
        return list(dict.fromkeys(self.devices))

    def _place_weights(self, tree: Any) -> Any:
        """Replicate ``tree`` to every other device of the mesh, once; keeps
        the replicas of the trees the engine still holds."""
        keep = {id(t) for t in (tree, getattr(self, "params", None), getattr(self, "_qparams", None))}
        self._placed = {k: v for k, v in self._placed.items() if k in keep}
        if id(tree) not in self._placed:
            self._placed[id(tree)] = (tree, {d: tree_to(tree, d) for d in self._weights_sharding()
                                             if d != self.device})
        return tree

    def _weights_on(self, dev: torch.device) -> Weights:
        """The module and the forward's weight tree on ``dev``."""
        tree = self._fwd_params()
        if dev == self.device:
            return Weights(self.module, tree)
        hit = self._placed.get(id(tree))
        if hit is None or hit[0] is not tree:
            self._place_weights(tree)
            hit = self._placed[id(tree)]
        module = None
        if self.forward_mode == "xla":  # the module forward reads the module's own parameters
            key = (id(self.module), id(self.params))
            got = self._modules.get(dev)
            if got is None or got[0] != key or got[1] is not self.module:
                self._modules[dev] = (key, self.module, copy.deepcopy(self.module).to(dev))
            module = self._modules[dev][2]
        return Weights(module, hit[1][dev])

    def _forward_on(self, dev: torch.device) -> tuple[Callable, Any]:
        """(forward, params) of ``_forward_fn`` on ``dev``."""
        w = self._weights_on(dev)
        return self._forward_fn(w.module), w.params

    # -- batch-sharded programs ------------------------------------------------------
    def _jit_replicated(self, run: Callable) -> Callable:
        def sharded(shards: list[torch.Tensor]) -> torch.Tensor:
            outs = []
            for i, t in enumerate(shards):
                dev = self.devices[i % self.n_devices]
                forward, params = self._forward_on(dev)
                outs.append(run(forward, params, t.to(dev)).to(self.device))
            return torch.cat(outs)

        return sharded

    def _constrain_tile_batch(self, tiles: torch.Tensor) -> list[torch.Tensor]:
        """A dense tile batch zero-padded to a device multiple, one equal shard a device."""
        n, nd = int(tiles.shape[0]), self.n_devices
        n_pad = -(-n // nd) * nd
        if n_pad != n:
            tiles = torch.cat([tiles, tiles.new_zeros((n_pad - n, *tiles.shape[1:]))])
        return list(torch.split(tiles, n_pad // nd))

    def _constrain_frame_batch(self, chunk: torch.Tensor) -> list[torch.Tensor]:
        """A global chunk of frames as the single-device chunks it holds, one a device."""
        return list(torch.split(chunk, self._frames_a_call))

    def _video_chunk(self, frame_chunk: int) -> int:
        self._frames_a_call = max(1, frame_chunk)
        return self._frames_a_call * self.n_devices

    def _run_chunks(self, fns: list, tiles: torch.Tensor, chunk: int) -> torch.Tensor:
        """``tiles`` in the single-device program's chunks (``chunk`` tiles,
        the remainder unpadded), chunk j on device j mod nd, run by that
        device's ``fns[j mod nd]``; gathered in order on the first device."""
        parts = []
        for j, k in enumerate(range(0, int(tiles.shape[0]), chunk)):
            i = j % self.n_devices
            parts.append(fns[i](tiles[k : k + chunk].to(self.devices[i])))
        return torch.cat([p.to(self.device) for p in parts])

    def _pipeline_for(self, plan) -> Callable:
        """The tiled pipeline with the tile batch sharded: the single-device
        chunks of ``tile_chunk`` tiles (the remainder unpadded) go to the
        devices in turn; the stitch gathers onto the first device."""
        chunk = min(self.tile_chunk, plan.n_tiles)

        def run(params, img_u8: torch.Tensor) -> torch.Tensor:
            fns = [self._forward_on(d) for d in self.devices]
            fns = [lambda t, f=f, p=p: f(p, t) for f, p in fns]
            padded = pad_to_plan(img_u8.to(torch.float32), plan)
            tiles = im2double(extract_tiles(padded, plan))
            out = self._run_chunks(fns, tiles, chunk) * 255.0
            return self._finalize_u8(crop_output(stitch_tiles(out, plan), plan))

        return run

    # -- whole-frame programs: bands of rows ------------------------------------------
    def _banded(self, stages, x: torch.Tensor, axis: int = 1) -> list[torch.Tensor]:
        """``x`` (on any device) cut into one band a device along ``axis``, run
        through ``stages``; the bands of the output, each on its device."""
        sizes = split_sizes(int(x.shape[axis]), self.n_devices)
        devs = self.devices[: len(sizes)]
        bands = [b.to(d) for b, d in zip(torch.split(x, sizes, dim=axis), devs)]
        return run_bands(stages, bands, [self._weights_on(d) for d in devs], axis)

    def _gather(self, bands: list[torch.Tensor], axis: int = 1) -> torch.Tensor:
        return torch.cat([b.to(self.device) for b in bands], axis)

    def _fast_fn(self, hw) -> Callable:
        body, tail = forward_stages(self)

        def run(params, img_u8: torch.Tensor) -> torch.Tensor:
            ys = self._banded(body + tail, im2double(img_u8)[None])
            return self._gather([self._finalize_u8(y[0] * 255.0) for y in ys], 0)

        return run

    def _frame_fn(self, hw) -> Callable:
        body, tail = forward_stages(self)
        return lambda params, x: self._gather(self._banded(body + tail, x))

    def _split_fn(self, hw) -> Callable:
        """split mode sharded: the body banded by rows; each tail stripe
        (rows [k - halo, k + t + halo) of the body map) banded by columns,
        with the same halo rule along them.  ``split_tile_w`` dispatches to
        the sharded 2-D tiled tail."""
        if self.split_tile_w:
            return self._split_fn_2d(hw)
        body, tail = forward_stages(self)
        body_up, ts, halo = self._split_geometry()
        h_total = int(hw[0]) * body_up
        t = max(1, self.split_tile)

        def run(params, img_u8: torch.Tensor) -> torch.Tensor:
            feats = self._banded(body, im2double(img_u8)[None])
            starts = np.cumsum([0] + [int(f.shape[1]) for f in feats])
            stripes = []
            for k in range(0, h_total, t):
                tt = min(t, h_total - k)
                s0, e0 = max(k - halo, 0), min(k + tt + halo, h_total)
                rows = [f.narrow(1, max(s0, a) - a, min(e0, z) - max(s0, a))
                        for f, a, z in zip(feats, starts[:-1], starts[1:]) if max(s0, a) < min(e0, z)]
                sizes = split_sizes(int(rows[0].shape[2]), self.n_devices)
                cols = []
                for j, (c, d) in enumerate(zip(np.cumsum([0] + sizes[:-1]), self.devices)):
                    cols.append(torch.cat([r.narrow(2, int(c), sizes[j]).to(d) for r in rows], 1))
                ys = run_bands(tail, cols, [self._weights_on(d) for d in self.devices[: len(cols)]], axis=2)
                ys = [self._finalize_u8(y[0, (k - s0) * ts : (k - s0 + tt) * ts] * 255.0) for y in ys]
                stripes.append(self._gather(ys, 1))
            return torch.cat(stripes, 0)

        return run

    def _split_fn_2d(self, hw) -> Callable:
        """The sharded 2-D tiled split: the body banded by rows and gathered,
        the shifted tail tiles in the single-device chunks of
        ``split2d_chunk`` (a global chunk of ``split2d_chunk`` a device), the
        chunks going to the devices in turn, each device running the
        single-device tail on its chunks; the stitch on the first device."""
        body, _ = forward_stages(self)
        g = self._split2d_geometry(hw)
        n_tiles = g["n_r"] * g["n_c"]
        chunk = min(max(1, self.split2d_chunk), n_tiles)
        rem = n_tiles % chunk
        if rem and n_tiles > rem:
            log.warning(
                "split2d: chunk %d does not divide the %dx%d=%d-tile batch (remainder %d) — the remainder "
                "batch is a second tail program, measured ~2.4x slower end-to-end; pick "
                "--split-tile/--split-tile-w so the tile count is a chunk multiple",
                chunk, g["n_r"], g["n_c"], n_tiles, rem,
            )

        def run(params, img_u8: torch.Tensor) -> torch.Tensor:
            feats = self._gather(self._banded(body, im2double(img_u8)[None]))
            tiles = self._split2d_extract(feats[0], g)
            fns = []
            for d in self.devices:
                w = self._weights_on(d)
                fns.append(lambda t, f=self._split_body_tail_fns(w.module)[1], p=w.params: f(p, t))
            y = self._run_chunks(fns, tiles, chunk)
            return self._finalize_u8(self._split2d_stitch(y, g) * 255.0)

        return run
