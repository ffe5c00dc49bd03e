"""SuperResolver, the inference engine (mirror of ``engine.py``, this slice's subset).

Per image, on the resolver's device:

    uint8 image -> pad -> extract tiles -> /255 -> generator over the tile
    batch in chunks of ``tile_chunk`` -> *255 -> stitch -> crop ->
    round/clip -> uint8

(``mode='patch'``, the reference's overlapped tiling), the generator over
the whole frame (``mode='fast'``), or the body over the whole frame and the
x4 tail over halo'd row stripes of the body map (``mode='split'``), or
over a batch of shifted 2-D tiles with ``split_tile_w``, in chunks of
``split2d_chunk``: the same output as fast mode at bounded tail memory.
``forward='xla'`` runs the ``nn.Module``; ``forward='pallas'`` runs
``apply_didbl_pallas``, whose LR blocks are the CUDA kernels, one launch
per block; ``forward='pallas_chain'`` the same with the 16 Light53 and the
6 Light blocks as one chain kernel each; ``forward='pallas_int8'`` runs
``apply_didbl_int8`` on a one-time quantized tree (``_fwd_params``), every
residual block on the int8 kernels; ``forward='int8'`` (the production
serving profile) runs ``apply_didbl_int8_xla`` on the same calibrated tree,
every residual block on the per-channel int8 kernels (``int8_dynamic_tail``:
per-sample dynamic scales in the HR tail; ``int8_body_tile``: the body over
shifted spatial tiles, the same output).  Float32 weights; TF32 is switched off.
``dtype=torch.bfloat16`` (or ``"bfloat16"``) runs ``xla``, ``pallas`` and
``pallas_chain`` in bf16, as the JAX engine's serving profile does: the
module's convs and combines, or the kernels' bf16 forms, with float32
outputs.  ``mixed=True`` (bf16 unless ``dtype`` says otherwise) gives the
module bf16-rounded conv operands with float32 emission everywhere,
``mixed="tail"`` only in the x4 tail; the ``pallas*`` forwards take only
the dtype, as in JAX, so there they run pure bf16, and the int8 forwards
take no dtype at all.  ``self_ensemble`` averages the x8 dihedral
transforms, ``back_projection=N`` refines the result against the LR input
(``ops/backproject.py``); ``upscale_patch_average``, ``upscale_frame`` and
``upscale_video`` are the reference's other entry points.
``internal_learn=N`` adapts a copy of the weights to each image for N train
steps before ``upscale`` serves it (``_internal_adapt``), and restores the
base weights afterwards; ``model_kwargs`` builds the model at non-default
widths, as the trainer's ``Config.model_kwargs`` does.

The data-parallel engine (``parallel/data_parallel.py``, ``ShardedResolver``)
reuses this one through its hooks, each the identity on one device:
``_weights_sharding`` / ``_place_weights`` (weight trees replicated to the
mesh's devices), ``_constrain_tile_batch`` / ``_constrain_frame_batch`` (a
batch cut into per-device shards), ``_jit_replicated`` (a per-shard program
run on each shard's device and gathered), ``_video_chunk``, and
``_fast_fn(hw)`` / ``_frame_fn(hw)`` (the whole-frame forwards, which it
cuts into bands of rows).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import numpy as np
import torch

from image_enhance_keras_tpu_torch.data.io import imread, imwrite, list_images
from image_enhance_keras_tpu_torch.models.blocks import profile_dtype
from image_enhance_keras_tpu_torch.models.weights import load_params, params_of_module
from image_enhance_keras_tpu_torch.models.zoo import get_model, init_params
from image_enhance_keras_tpu_torch.models.zoo_int8 import int8_support
from image_enhance_keras_tpu_torch.ops.color import im2double
from image_enhance_keras_tpu_torch.ops.conv import disable_tf32
from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8
from image_enhance_keras_tpu_torch.tiling.tiles import (
    TilePlan,
    crop_output,
    extract_tiles,
    pad_to_plan,
    plan_tiles,
    stitch_tiles,
)
from image_enhance_keras_tpu_torch.utils.logging import get_logger
from image_enhance_keras_tpu_torch.utils.profiling import (
    COUNT_D2H_BYTES,
    COUNT_FORWARD_CALLS,
    COUNT_FORWARD_PIXELS,
    COUNT_IMAGES,
    SPAN_D2H,
    SPAN_EXTRACT,
    SPAN_FINALIZE,
    SPAN_FORWARD,
    SPAN_H2D,
    SPAN_STITCH,
    SPAN_UPSCALE,
    SPAN_WAIT,
    count,
    span,
    tracing,
)

__all__ = ["SuperResolver", "output_name", "resolve_device", "TILE_GEOMETRIES"]

log = get_logger(__name__)


def output_name(img_path: str, suffix: str = "scaled", scale_label: int = 1) -> str:
    """`<stem>_<suffix>(<k>x)<ext>` — the reference naming contract."""
    stem, ext = os.path.splitext(img_path)
    return f"{stem}_{suffix}({scale_label}x){ext}"


#: tile geometries (patch, step, crop): "ref" is the reference's 96/64/8
TILE_GEOMETRIES = {"ref": (96, 64, 8), "perf": (192, 176, 8)}


def _forward_call(forward: Callable, params: Any, x: torch.Tensor, from_image: bool = True) -> torch.Tensor:
    """One counted call of a forward, in its span; ``from_image``: the call
    starts from the image (a chunk of tiles, the frame, the body), whose
    input pixels are counted, and not from a body map (a tail stripe or tile)."""
    count(COUNT_FORWARD_CALLS)
    if from_image:
        count(COUNT_FORWARD_PIXELS, int(x.shape[0]) * int(x.shape[1]) * int(x.shape[2]))
    with span(SPAN_FORWARD):
        return forward(params, x)


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on; CUDA must be present unless the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


class SuperResolver:
    """Directory / image x4 upscaler around one model and its weights."""

    def __init__(
        self,
        model: str = "didbl",
        weights: str | None = None,
        dtype: Any = None,
        patch: int = 96,
        step: int = 64,
        crop: int = 8,
        geometry: str | None = None,
        scalemulti: int = 4,
        tile_chunk: int = 16,
        params: Any = None,
        seed: int = 0,
        forward: str = "xla",
        mode: str = "patch",
        fast_max_pixels: int = 1 << 20,
        split_tile: int = 64,
        split_tile_w: int | None = None,
        self_ensemble: bool = False,
        back_projection: int = 0,
        round_mode: str = "round",
        mixed: bool | str = False,
        internal_learn: int = 0,
        module_and_spec: tuple | None = None,
        model_kwargs: dict | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        disable_tf32()
        if forward not in ("xla", "int8", "pallas", "pallas_chain", "pallas_int8"):
            raise ValueError(f"forward={forward!r} is not a forward of this package or of the JAX package "
                             "(xla, int8, pallas, pallas_chain, pallas_int8)")
        if mode not in ("patch", "fast", "split"):
            raise ValueError(f"mode must be 'patch', 'fast' or 'split', got {mode!r}")
        if round_mode not in ("round", "trunc"):
            raise ValueError(f"round_mode must be 'round' or 'trunc', got {round_mode!r}")
        if mixed and dtype is None:
            dtype = torch.bfloat16  # the mixed profiles' dots default to the serving bf16
        #: the dtype the pallas* forwards run in (bf16 under both mixed profiles)
        self._dtype = profile_dtype(dtype)
        self.model_name = model
        if module_and_spec is not None:
            self.module, self.spec = module_and_spec
        else:
            # non-default graph configs (narrow test widths, the LOO scripts'
            # capacity probes) flow through as the Trainer's model_kwargs do;
            # the weights must match the config
            kw = dict(model_kwargs or {})
            if mixed:
                kw["mixed_tail" if mixed == "tail" else "mixed"] = True
            self.module, self.spec = get_model(model, dtype=dtype, **kw)
        if forward.startswith("pallas") and not model.startswith("didbl"):
            raise ValueError("pallas forwards are implemented for the didbl family")
        if forward.startswith("pallas") and getattr(self.module, "upsampler", "tf1_bilinear") != "tf1_bilinear":
            # JAX lets pallas / pallas_chain through here and computes the TF1
            # x4 in place of the subpixel head (its apply_didbl_pallas has no
            # upsampler): a different function; the port refuses it
            raise ValueError(f"forward={forward!r}: the pallas forwards implement the TF1 head only, "
                             f"not upsampler={self.module.upsampler!r}")
        if forward == "int8" and int8_support(self.module) is None:
            raise ValueError(f"forward='int8' is not available for {model!r}")
        self.forward_mode = forward
        if geometry is not None:
            patch, step, crop = TILE_GEOMETRIES[geometry]
        self.patch = patch
        self.step = step
        self.crop = crop
        #: pre-upscaled-input models (difvdsr) refine a PIL-bicubic x``scalemulti`` of the input
        self.scalemulti = scalemulti
        # tile_chunk is calibrated for 96px tiles; scale it with tile area
        self.tile_chunk = max(1, tile_chunk * (96 * 96) // (patch * patch))
        self.mode = mode
        self.fast_max_pixels = fast_max_pixels
        self.split_tile = split_tile
        self.split_tile_w = split_tile_w
        self.self_ensemble = self_ensemble
        self.back_projection = int(back_projection)
        self.round_mode = round_mode
        self.internal_learn = int(internal_learn)

        self.module = self.module.to(self.device).eval().requires_grad_(False)
        self._qparams = None
        if params is not None:
            load_params(self.module, params)
        else:
            init_params(self.module, seed)
            if weights is not None:
                self.params = params_of_module(self.module)
                self.load_weights(weights)
        self.params = self._place_weights(params_of_module(self.module))
        self._calib_x = None
        self.int8_calib_source: str | None = None

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def load_weights(self, path: str) -> None:
        """Load a params .npz export, a Keras .h5 checkpoint, or the params of
        a full train-state directory of the port's trainer (``latest/`` or
        ``best/``); orbax directories are not read."""
        if path.endswith(".h5"):
            from image_enhance_keras_tpu_torch.models.keras_import import import_keras_weights

            load_params(self.module, import_keras_weights(path, self.model_name, self.params))
        elif path.endswith(".npz"):
            from image_enhance_keras_tpu_torch.train.checkpoints import load_params_npz

            load_params(self.module, load_params_npz(path))
        elif os.path.isdir(path):
            from image_enhance_keras_tpu_torch.train.checkpoints import restore_params

            load_params(self.module, restore_params(path)["params"])  # flax path -> tensor
        else:
            raise NotImplementedError(f"loading {path!r}: not an .h5, an .npz or a checkpoint directory")
        self.params = self._place_weights(params_of_module(self.module))
        self._qparams = None  # re-quantize int8 weights on next use

    def _weights_sharding(self) -> list[torch.device] | None:
        """The devices weight trees are replicated to; None: the resolver's
        own device only.  The sharded engine returns its mesh's devices, so
        that weights loaded, quantized or adapted after construction are
        replicated once, not copied on every call."""
        return None

    def _place_weights(self, tree: Any) -> Any:
        """A weight tree (params or int8 qparams) placed for the forwards:
        the tree itself on one device (it lives on ``self.device``)."""
        return tree

    # ------------------------------------------------------------------
    # tiled pipeline
    # ------------------------------------------------------------------
    def _pipeline_for(self, plan: TilePlan) -> Callable:
        """params, uint8 (H, W, 3) tensor -> uint8 (4H, 4W, 3) over the tile plan;
        the chunks run one after another on this device."""
        forward = self._forward_fn()
        n = plan.n_tiles
        # full chunks of tile_chunk plus one remainder call; no dummy tiles
        chunk = min(self.tile_chunk, n)
        rem = n % chunk
        n_full = n - rem

        def run(params, img_u8: torch.Tensor) -> torch.Tensor:
            with span(SPAN_EXTRACT):
                padded = pad_to_plan(img_u8.to(torch.float32), plan)
                tiles = im2double(extract_tiles(padded, plan))
            outs = [_forward_call(forward, params, tiles[i : i + chunk]) for i in range(0, n_full, chunk)]
            if rem:
                outs.append(_forward_call(forward, params, tiles[n_full:]))
            with span(SPAN_STITCH):
                out = crop_output(stitch_tiles(torch.cat(outs) * 255.0, plan), plan)
            return self._finalize_u8(out)

        return run

    def _forward_fn(self, module: torch.nn.Module | None = None) -> Callable:
        """params, (N,h,w,3) [0,1] -> (N,sh,sw,3): the module (``module``, a
        replica of it on another device, when given) or a kernel forward."""
        if self.forward_mode == "int8":
            if self.int8_dynamic_tail or self.int8_body_tile:
                body_fn, tail_fn = self._split_body_tail_fns(module)
                return lambda qp, x: tail_fn(qp, body_fn(qp, x))
            return int8_support(self.module)[1]
        if self.forward_mode == "pallas_int8":
            from image_enhance_keras_tpu_torch.models.didbl_pallas import apply_didbl_int8

            m = self.module
            if getattr(m, "upsampler", "tf1_bilinear") != "tf1_bilinear":
                raise ValueError("pallas_int8 supports the tf1_bilinear head")
            return lambda qp, b: apply_didbl_int8(
                qp, b, n_body53=m.n_body53, n_light=m.n_light, n_tail53=m.n_tail53, scale=m.scale,
            )
        if self.forward_mode in ("pallas", "pallas_chain"):
            from image_enhance_keras_tpu_torch.models.didbl_pallas import apply_didbl_pallas

            m = self.module
            chain = self.forward_mode == "pallas_chain"
            return lambda params, b: apply_didbl_pallas(
                params, b, dtype=self._dtype, n_body53=m.n_body53, n_light=m.n_light,
                n_tail53=m.n_tail53, scale=m.scale, chain=chain,
            )
        module = self.module if module is None else module
        return lambda params, b: module(b)

    def _finalize_u8(self, y: torch.Tensor) -> torch.Tensor:
        """[0,255]-domain float -> uint8: "round" is half-to-even, "trunc" the reference's cast."""
        with span(SPAN_FINALIZE):
            if self.round_mode == "trunc":
                return torch.clamp(torch.floor(y), 0.0, 255.0).to(torch.uint8)
            return torch.clamp(torch.round(y), 0.0, 255.0).to(torch.uint8)

    @staticmethod
    def _to_host(y: torch.Tensor) -> np.ndarray:
        """The uint8 output as a host array.  While a profiler records, the
        device is waited for first, in a span of its own, so that the copy's
        span holds the copy alone; untraced, ``.cpu()`` does the wait."""
        if y.is_cuda and tracing():
            with span(SPAN_WAIT):
                torch.cuda.current_stream(y.device).synchronize()
        with span(SPAN_D2H):
            out = y.cpu().numpy()
        count(COUNT_D2H_BYTES, out.nbytes)
        return out

    def _finalize_u8_np(self, y: np.ndarray) -> np.ndarray:
        """Host twin of :meth:`_finalize_u8` (the x8 ensemble average); np.round is half to even."""
        if self.round_mode == "trunc":
            return np.clip(np.floor(y), 0.0, 255.0).astype(np.uint8)
        return np.clip(np.round(y), 0.0, 255.0).astype(np.uint8)

    def _fast_fn(self, hw) -> Callable:
        """Whole-frame forward with no tiling, for an (H, W) = ``hw`` frame."""
        forward = self._forward_fn()

        def run(params, img_u8: torch.Tensor) -> torch.Tensor:
            y = _forward_call(forward, params, im2double(img_u8)[None])
            with span(SPAN_STITCH):
                y = y[0] * 255.0
            return self._finalize_u8(y)

        return run

    # ------------------------------------------------------------------
    # split mode: whole-frame body, tail over stripes or 2-D tiles
    # ------------------------------------------------------------------
    #: tail tiles per call of split mode's 2-D tiled tail
    split2d_chunk: int = 8

    def _supports_split(self) -> bool:
        m = self.module
        return callable(getattr(m, "body", None)) and callable(
            getattr(m, getattr(m, "split_tail_method", "tail"), None))

    def _split_geometry(self) -> tuple[int, int, int]:
        """(body_up, ts, halo): the body map's scale over the input, the
        tail's over the body map, and the body-map halo a tail stripe needs,
        as the module declares them."""
        m = self.module
        return (int(getattr(m, "body_upscale", 1)), int(getattr(m, "tail_upscale", m.scale)),
                int(getattr(m, "split_halo", 3)))

    def _split_body_tail_fns(self, module: torch.nn.Module | None = None) -> tuple[Callable, Callable]:
        """(body_fn, tail_fn) of the forward: the module's body and tail for
        ``xla`` (``module``, a replica on another device, when given), the
        int8 bodies and tails for ``int8`` and ``pallas_int8`` (the same
        receptive field, so the module's ``split_halo`` holds); ``int8``
        honours ``int8_dynamic_tail`` and ``int8_body_tile``."""
        module = self.module if module is None else module
        fm = self.forward_mode
        if fm == "xla":
            tail = getattr(module, getattr(module, "split_tail_method", "tail"))
            return (lambda p, x: module.body(x)), (lambda p, h: tail(h))
        if fm == "int8":
            from image_enhance_keras_tpu_torch.models import didbl_pallas as dp

            sup = int8_support(module)
            if sup is None or sup[2] is None:
                raise ValueError(f"mode='split' with forward='int8' is not available for {self.model_name!r}")
            body_fn, tail_fn = sup[2], sup[3]
            m = module
            if (self.int8_dynamic_tail or self.int8_body_tile) and type(m).__name__ != "DifvdsrDouble":
                raise ValueError("int8_dynamic_tail / int8_body_tile are implemented for the didbl family")
            if self.int8_dynamic_tail:
                tail_fn = lambda qp, h: dp.apply_didbl_int8_xla_tail(
                    qp, h, n_tail53=m.n_tail53, scale=m.scale, dynamic=True, upsampler=m.upsampler)
            if self.int8_body_tile:
                tile, seg = int(self.int8_body_tile), int(self.int8_body_seg)
                body_fn = lambda qp, x: dp.apply_didbl_int8_xla_body_tiled(
                    qp, x, n_body53=m.n_body53, n_light=m.n_light, tile=tile, seg=seg)
            return body_fn, tail_fn
        if fm == "pallas_int8":
            from image_enhance_keras_tpu_torch.models.didbl_pallas import apply_didbl_int8_body, apply_didbl_int8_tail

            m = module
            if getattr(m, "upsampler", "tf1_bilinear") != "tf1_bilinear":
                raise ValueError("pallas_int8 supports the tf1_bilinear head")
            return (lambda qp, x: apply_didbl_int8_body(qp, x, n_body53=m.n_body53, n_light=m.n_light),
                    lambda qp, h: apply_didbl_int8_tail(qp, h, n_tail53=m.n_tail53, scale=m.scale))
        raise ValueError(f"mode='split' supports the xla/int8/pallas_int8 forwards, not {fm!r}")

    def _split_fn(self, hw) -> Callable:
        """Whole-frame body + halo-striped tail: the stripe of tail rows
        [ts*k, ts*(k+t)) runs on body-map rows [k - halo, k + t + halo),
        clamped at the edges, where clamped sampling and zero conv padding
        coincide with the whole frame's; tail memory is bounded by
        ``split_tile`` body-map rows.  ``split_tile_w`` switches to the 2-D
        tiled tail."""
        if self.split_tile_w:
            return self._split_fn_2d(hw)
        body_fn, tail_fn = self._split_body_tail_fns()
        body_up, ts, halo = self._split_geometry()
        h_total = int(hw[0]) * body_up  # body-map rows
        t = max(1, self.split_tile)

        def run(params, img_u8: torch.Tensor) -> torch.Tensor:
            feats = _forward_call(body_fn, params, im2double(img_u8)[None])
            outs = []
            for k in range(0, h_total, t):
                tt = min(t, h_total - k)
                s0, e0 = max(k - halo, 0), min(k + tt + halo, h_total)
                y = _forward_call(tail_fn, params, feats[:, s0:e0].contiguous(), from_image=False)
                outs.append(y[:, (k - s0) * ts : (k - s0 + tt) * ts])
            with span(SPAN_STITCH):
                y = torch.cat(outs, dim=1)[0] * 255.0
            return self._finalize_u8(y)

        return run

    def _split2d_geometry(self, hw) -> dict:
        """Tile counts and sizes of the shifted 2-D grid, and its extract and
        stitch index vectors on the device."""
        from image_enhance_keras_tpu_torch.tiling.tiles import (
            shift_grid_axis,
            shifted_extract_indices,
            shifted_stitch_indices,
        )

        body_up, ts, halo = self._split_geometry()
        hb, wb = int(hw[0]) * body_up, int(hw[1]) * body_up
        t_r, t_c = max(1, self.split_tile), max(1, int(self.split_tile_w))
        T_r, starts_r, _ = shift_grid_axis(hb, t_r, halo)
        T_c, starts_c, _ = shift_grid_axis(wb, t_c, halo)

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        return dict(
            ts=ts, n_r=len(starts_r), n_c=len(starts_c), T_r=T_r, T_c=T_c,
            ex_r=dev(shifted_extract_indices(hb, t_r, halo)), ex_c=dev(shifted_extract_indices(wb, t_c, halo)),
            st_r=dev(shifted_stitch_indices(hb, t_r, halo, ts)), st_c=dev(shifted_stitch_indices(wb, t_c, halo, ts)),
        )

    @staticmethod
    def _split2d_extract(feats: torch.Tensor, g: dict) -> torch.Tensor:
        """(hb, wb, C) body map -> (n_r*n_c, T_r, T_c, C) shifted tiles."""
        from image_enhance_keras_tpu_torch.tiling.tiles import gather_tiles_2d

        return gather_tiles_2d(feats, g["ex_r"], g["ex_c"], g["n_r"], g["n_c"], g["T_r"], g["T_c"])

    @staticmethod
    def _split2d_stitch(y: torch.Tensor, g: dict) -> torch.Tensor:
        """(n_r*n_c, T_r*ts, T_c*ts, C) tail tiles -> (hb*ts, wb*ts, C), the owned crops."""
        from image_enhance_keras_tpu_torch.tiling.tiles import scatter_tiles_2d

        return scatter_tiles_2d(y, g["st_r"], g["st_c"], g["n_r"], g["n_c"], g["T_r"], g["T_c"], scale=g["ts"])

    def _split_fn_2d(self, hw) -> Callable:
        """split with a 2-D tiled tail: the body map cut into uniform (t +
        2*halo)-sized shifted tiles on both axes, the tail over the tile batch
        in chunks of ``split2d_chunk``, the owned crops stitched back."""
        body_fn, tail_fn = self._split_body_tail_fns()
        g = self._split2d_geometry(hw)
        n_tiles = g["n_r"] * g["n_c"]
        chunk = min(max(1, self.split2d_chunk), n_tiles)
        rem = n_tiles % chunk
        n_full = n_tiles - rem
        if rem and n_full:
            log.warning(
                "split2d: chunk %d does not divide the %dx%d=%d-tile batch "
                "(remainder %d) — the remainder batch is a second tail "
                "program, measured ~2.4x slower end-to-end; pick "
                "--split-tile/--split-tile-w so the tile count is a chunk "
                "multiple (e.g. 128/128 with chunk 8 at 512^2)",
                chunk, g["n_r"], g["n_c"], n_tiles, rem,
            )

        def run(params, img_u8: torch.Tensor) -> torch.Tensor:
            feats = _forward_call(body_fn, params, im2double(img_u8)[None])
            with span(SPAN_EXTRACT):
                tiles = self._split2d_extract(feats[0], g)
            parts = [_forward_call(tail_fn, params, tiles[i : i + chunk], from_image=False)
                     for i in range(0, n_full, chunk)]
            if rem:
                parts.append(_forward_call(tail_fn, params, tiles[n_full:], from_image=False))
            with span(SPAN_STITCH):
                y = self._split2d_stitch(torch.cat(parts), g) * 255.0
            return self._finalize_u8(y)

        return run

    # ------------------------------------------------------------------
    # int8 serving parameters
    # ------------------------------------------------------------------
    #: int8 calibration source:
    #:   "images"      (default): serving-distribution LR crops of real
    #:                 images, from ``int8_calib_dir`` when set, else the
    #:                 package-bundled photos (never eval images), else
    #:                 procedural dead-leaves / pink-noise images;
    #:   "synthetic"   4 deterministic procedural tiles;
    #:   "first_frame" a central crop of the first frame served.
    int8_calib: str = "images"
    #: image directory for int8_calib="images" (None: the bundled photos)
    int8_calib_dir: str | None = None
    #: ``forward='int8'``: quantize the HR tail with per-sample dynamic
    #: scales (per tile in split2d) instead of the calibrated ones
    int8_dynamic_tail: bool = False
    #: ``forward='int8'``: spatial tile of the body (0: the whole frame),
    #: run in segments of ``int8_body_seg`` blocks over shifted tiles
    int8_body_tile: int = 0
    int8_body_seg: int = 4

    def _calib_from_images(self) -> torch.Tensor | None:
        """(N, s, s, 3) [0,1] calibration inputs from ``int8_calib_dir``, or None."""
        from image_enhance_keras_tpu_torch.utils.paths import find_repo_asset

        if not self.int8_calib_dir:
            return None
        calib_dir = find_repo_asset(self.int8_calib_dir)  # CWD-independent
        if calib_dir is None:
            return None
        try:
            paths = [p for p in list_images(calib_dir) if "scaled" not in os.path.basename(p)]
        except OSError:
            return None
        s = self._calib_scale()
        imgs = []
        for p in paths:
            # cap after the usability filter: small files must not use up the cap
            if len(imgs) >= 8:
                break
            try:
                img = np.asarray(imread(p))
            except (OSError, ValueError):
                continue
            if min(img.shape[:2]) < s * 16:
                continue
            imgs.append(img)
        return self._calib_from_arrays(imgs, s)

    def _calib_scale(self) -> int:
        """Degradation factor of the serving distribution: ``scalemulti`` for
        pre-upscaled-input models (their crops round-trip by it), else the
        net's own scale."""
        if self.spec.pre_upscaled_input:
            return max(1, int(self.scalemulti))
        return max(1, int(self.spec.net_scale))

    def _calib_from_arrays(self, imgs, s: int) -> torch.Tensor | None:
        """HR uint8 arrays -> (N, cs, cs, 3) [0,1] LR crops: central crop to a
        multiple of ``s``, PIL-bicubic /s, common central square of at most
        128; pre-upscaled-input models get those crops PIL-bicubic x``s``."""
        crops = []
        for img in imgs:
            h, w = img.shape[:2]
            if min(h, w) < s * 16:
                continue
            hh, ww = (h // s) * s, (w // s) * s
            img = img[(h - hh) // 2 : (h - hh) // 2 + hh, (w - ww) // 2 : (w - ww) // 2 + ww]
            crops.append(resize_pil_uint8(torch.from_numpy(np.array(img)), (hh // s, ww // s)).numpy())
        if not crops:
            return None
        cs = min(min(min(c.shape[0], c.shape[1]) for c in crops), 128)
        crops = [
            c[(c.shape[0] - cs) // 2 : (c.shape[0] - cs) // 2 + cs,
              (c.shape[1] - cs) // 2 : (c.shape[1] - cs) // 2 + cs]
            for c in crops
        ]
        calib = torch.from_numpy(np.stack(crops).astype(np.float32))
        if self.spec.pre_upscaled_input:
            calib = resize_pil_uint8(calib, (cs * s, cs * s))
        return im2double(calib)

    def _maybe_calibrate_int8(self, img_u8: np.ndarray) -> None:
        """First-frame int8 calibration (``int8_calib="first_frame"``)."""
        if self.int8_calib != "first_frame" or self.forward_mode not in ("int8", "pallas_int8"):
            return
        if self._qparams is not None:
            return
        h, w = img_u8.shape[:2]
        ch, cw = min(h, 128), min(w, 128)
        y0, x0 = (h - ch) // 2, (w - cw) // 2
        crop = np.asarray(img_u8[y0 : y0 + ch, x0 : x0 + cw], np.float32)
        self._calib_x = im2double(torch.from_numpy(crop))[None]

    def _calibration_input(self) -> torch.Tensor:
        """The calibration batch, by ``int8_calib``, with its fallbacks.

        Logs the source and keeps it in ``int8_calib_source``."""
        from image_enhance_keras_tpu_torch.data.pipeline import (
            builtin_photos,
            rich_synthetic_images,
            synthetic_images,
        )

        calib, src = None, "central crop of the first frame"
        if self._calib_x is not None:
            calib = self._calib_x
        elif self.int8_calib == "images":
            calib, src = self._calib_from_images(), f"images under {self.int8_calib_dir!r}"
            if calib is None:
                photos = builtin_photos()
                src = "package-bundled real photos" if photos else "procedural dead-leaves images"
                if self.int8_calib_dir:
                    log.warning("int8_calib='images' but no usable images under %r; calibrating on %s",
                                self.int8_calib_dir, src)
                if photos:
                    calib = self._calib_from_arrays(photos, self._calib_scale())
                if calib is None:
                    src = "procedural dead-leaves images"
                    calib = self._calib_from_arrays(rich_synthetic_images(8, 256, seed=17),
                                                    self._calib_scale())
        if calib is None:
            src = "synthetic 128x128 tiles"
            calib = im2double(torch.from_numpy(np.stack(synthetic_images(4, 128))))
            if self.spec.pre_upscaled_input:
                # a bicubic down / up round trip of the first tile (a
                # first-frame crop is already pre-upscaled serving input)
                lr = resize_pil_uint8(calib[0] * 255.0, (32, 32))
                calib = im2double(resize_pil_uint8(lr, (128, 128)))[None]
        self.int8_calib_source = src
        log.info("int8 calibration: %s, %d x %dx%d", src, *calib.shape[:3])
        return calib

    def _fwd_params(self) -> Any:
        """Tree fed to the forward: the float params, or for the int8 forwards
        the one-time quantized tree with calibrated activation scales."""
        if self.forward_mode not in ("int8", "pallas_int8"):
            return self.params
        if self._qparams is None:
            calib = self._calibration_input().to(self.device)
            if self.forward_mode == "int8":
                qp = int8_support(self.module)[0](self.params, calib)
            else:
                from image_enhance_keras_tpu_torch.models.didbl_pallas import quantize_didbl_params

                m = self.module
                qp = quantize_didbl_params(
                    self.params, n_body53=m.n_body53, n_light=m.n_light, n_tail53=m.n_tail53,
                    calib_x=calib, scale=m.scale,
                )
            self._qparams = self._place_weights(qp)
        return self._qparams

    def plan_for(self, height: int, width: int) -> TilePlan:
        return plan_tiles(height, width, patch=self.patch, step=self.step,
                          scale=self.spec.net_scale, crop=self.crop)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    #: ZSSR-style per-image test-time adaptation ("Zero-Shot
    #: Super-Resolution", Shocher et al. 2018): before upscaling an image,
    #: fine-tune a copy of the weights for N steps on (input degraded by the
    #: net scale, input) pairs built from the input itself, with the
    #: degradation serving assumes.  0 = off.
    internal_learn: int = 0
    #: adaptation settings: a small learning rate (the net is pre-trained,
    #: the pseudo-corpus is one image), charbonnier, a batch of augmented crops
    internal_learn_lr: float = 2e-5
    internal_learn_batch: int = 8
    internal_learn_loss: str = "charbonnier"

    def _internal_adapt(self, img_u8: np.ndarray, steps: int):
        """A fine-tuned copy of the module for this image, with the module
        and ``self.params`` untouched; None (serve the base weights) when the
        input is too small for adaptation patches.

        Patches of the serving input are the "HR" targets; the train step
        degrades them by the net scale (blur 0, the serving distribution)
        and learns to reconstruct them, under the x8 dihedral augmentation,
        with the frozen groups of ``mask_frozen`` left as they are.  Runs
        outside inference mode: the copy's parameters are ordinary tensors."""
        import copy

        from image_enhance_keras_tpu_torch.data.pipeline import PatchSampler
        from image_enhance_keras_tpu_torch.train.trainer import Adam, TrainState, make_train_step, mask_frozen

        scale = self._calib_scale()
        h, w = img_u8.shape[:2]
        hr_patch = min(64, (min(h, w) // scale) * scale)
        if hr_patch < scale * 6:
            log.warning("internal_learn: input %dx%d too small for x%d adaptation patches; serving the base "
                        "weights", w, h, scale)
            return None
        sampler = PatchSampler([np.asarray(img_u8)], hr_patch=hr_patch, batch_size=int(self.internal_learn_batch),
                               seed=0, augment=True)
        t0 = time.time()
        with torch.inference_mode(False):
            module = copy.deepcopy(self.module)
            state = TrainState(module, Adam(mask_frozen(module), float(self.internal_learn_lr), b1=0.9))
            step = make_train_step(scale, blur_sigma=0.0, pre_upscale=self.spec.pre_upscaled_input,
                                   loss=str(self.internal_learn_loss))
            for _ in range(int(steps)):
                state, metrics = step(state, torch.from_numpy(sampler.sample()).to(self.device))
            loss = float(metrics["loss"])
        log.info("internal_learn: %d steps on %dx%d input (%.1fs, final loss %.5f)",
                 steps, w, h, time.time() - t0, loss)
        return module.eval().requires_grad_(False)

    @torch.inference_mode()
    def upscale(self, img: np.ndarray) -> np.ndarray:
        """uint8 RGB (H, W, 3) -> uint8 RGB x4 in ``mode`` 'patch', 'fast' or
        'split', under the x8 self-ensemble if ``self_ensemble``, then
        ``back_projection`` steps against the input.  With ``internal_learn``
        the image is served by a copy of the weights adapted to it, once
        before any ensemble transform; the base module, params and int8
        scales (recalibrated on the adapted params) are restored afterwards."""
        img = np.asarray(img)
        count(COUNT_IMAGES)
        with span(SPAN_UPSCALE):
            if self.internal_learn > 0:
                adapted = self._internal_adapt(img, self.internal_learn)
                if adapted is not None:
                    saved = (self.module, self.params, self._qparams)
                    self.module, self._qparams = adapted, None
                    self.params = self._place_weights(params_of_module(adapted))
                    try:
                        return self._upscale_post(img)
                    finally:
                        self.module, self.params, self._qparams = saved
            return self._upscale_post(img)

    def _upscale_post(self, img: np.ndarray) -> np.ndarray:
        out = self._upscale_ensemble(img) if self.self_ensemble else self._upscale_single(img)
        if self.back_projection > 0:
            out = self._back_project(out, img, self.back_projection)
        return out

    def _back_project(self, sr_u8: np.ndarray, lr_u8: np.ndarray, iters: int) -> np.ndarray:
        """Back-projection of a frame (H, W, C) or a batch (T, H, W, C) on the device."""
        if sr_u8.shape[-3] % lr_u8.shape[-3] or sr_u8.shape[-2] % lr_u8.shape[-2]:
            log.warning("back_projection skipped: SR %s is not an integer multiple of LR %s",
                        sr_u8.shape[-3:-1], lr_u8.shape[-3:-1])
            return sr_u8
        from image_enhance_keras_tpu_torch.ops.backproject import back_project

        sr = torch.from_numpy(np.ascontiguousarray(sr_u8)).to(self.device)
        lr = torch.from_numpy(np.ascontiguousarray(lr_u8)).to(self.device)
        return back_project(sr, lr, iters=iters).cpu().numpy()

    def _upscale_ensemble(self, img: np.ndarray) -> np.ndarray:
        """x8 geometric self-ensemble: upscale every rot90/flip of the input,
        undo the transform on each output, average the eight in float32 on
        the host, round once."""
        acc = None
        for k in range(4):
            for flip in (False, True):
                t = np.rot90(img, k)
                if flip:
                    t = t[:, ::-1]
                y = self._upscale_single(np.ascontiguousarray(t)).astype(np.float32)
                if flip:
                    y = y[:, ::-1]
                y = np.rot90(y, -k)
                acc = y if acc is None else acc + y
        return self._finalize_u8_np(acc / 8.0)

    def _pre_upscale(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-upscaled-input models refine a PIL-bicubic x``scalemulti`` of the
        input, so every x4 entry point upscales first; the identity for the
        others.  x: (..., H, W, C) in [0, 255], float32 out."""
        if not self.spec.pre_upscaled_input:
            return x.to(torch.float32)
        s = self.scalemulti
        return resize_pil_uint8(x, (x.shape[-3] * s, x.shape[-2] * s))

    def _upscale_single(self, img: np.ndarray) -> np.ndarray:
        img = np.ascontiguousarray(img)
        if self.spec.pre_upscaled_input:
            up = self._pre_upscale(torch.tensor(img, device=self.device))
            img = up.to(torch.uint8).cpu().numpy()
        self._maybe_calibrate_int8(img)
        with span(SPAN_H2D):
            x = torch.tensor(img, device=self.device)
        if self.mode == "split":
            if self._supports_split():
                return self._to_host(self._split_fn(img.shape[:2])(self._fwd_params(), x))
            log.warning(
                "mode='split' unavailable for %r (no body/tail decomposition); falling back to "
                "the tiled patch pipeline (different border semantics)", self.model_name,
            )
        if self.mode == "fast":
            if img.shape[0] * img.shape[1] <= self.fast_max_pixels:
                return self._to_host(self._fast_fn(img.shape[:2])(self._fwd_params(), x))
            log.warning(
                "mode='fast' frame %dx%d exceeds fast_max_pixels=%d; falling back to the "
                "tiled patch pipeline (interior-identical, borders differ within the conv "
                "receptive field) — use mode='split' for whole-frame semantics at bounded "
                "memory", img.shape[1], img.shape[0], self.fast_max_pixels,
            )
        plan = self.plan_for(img.shape[0], img.shape[1])
        return self._to_host(self._pipeline_for(plan)(self._fwd_params(), x))

    @torch.inference_mode()
    def upscale_patch_average(self, img: np.ndarray, patch: int = 32, step: int = 16) -> np.ndarray:
        """The reference ``upscalePatch``: dense patches at ``step``, each
        PIL-bicubic downscaled by the net scale, reconstructed by the network
        and overlap-averaged back (4-px interior trim): a same-size pass."""
        import torch.nn.functional as F

        from image_enhance_keras_tpu_torch.tiling.dense import extract_dense_patches, reconstruct_average

        img = np.asarray(img)
        h, w = img.shape[:2]
        s = step
        h2 = patch + -(-(max(h - patch, 0)) // s) * s
        w2 = patch + -(-(max(w - patch, 0)) // s) * s
        scale = self.spec.net_scale
        x = torch.tensor(np.ascontiguousarray(img), device=self.device).to(torch.float32)
        tiles = extract_dense_patches(F.pad(x, (0, 0, 0, w2 - w, 0, h2 - h)), patch, s)

        def run(forward, params, t):
            lr = resize_pil_uint8(t, (patch // scale, patch // scale))
            return forward(params, im2double(lr)) * 255.0

        # sharded engines pad the batch to a device multiple and cut it into
        # per-device shards here; one shard on one device
        y = self._jit_replicated(run)(self._constrain_tile_batch(tiles))[: tiles.shape[0]]
        recon = reconstruct_average(y, (h2, w2), step=s, pad=4)
        return self._finalize_u8(recon[:h, :w]).cpu().numpy()

    def _constrain_tile_batch(self, tiles: torch.Tensor) -> list[torch.Tensor]:
        """A dense tile batch as per-device shards: ``[tiles]`` on one device."""
        return [tiles]

    def _constrain_frame_batch(self, chunk: torch.Tensor) -> list[torch.Tensor]:
        """A chunk of frames as per-device shards: ``[chunk]`` on one device."""
        return [chunk]

    def _video_chunk(self, frame_chunk: int) -> int:
        """Frames a call of the video forward takes: ``frame_chunk`` on one
        device, a device-count multiple of it on a mesh."""
        return max(1, frame_chunk)

    def _jit_replicated(self, run: Callable) -> Callable:
        """``run(forward, params, shard)``, a per-shard program, as a function
        of the shards that runs it on each shard and gathers the results in
        order on this device (on one device: one call)."""
        forward, params = self._forward_fn(), self._fwd_params()
        return lambda shards: torch.cat([run(forward, params, t) for t in shards])

    def _frame_fn(self, hw) -> Callable:
        """params, (1, H, W, 3) [0,1] -> the forward's float output for an (H, W) = ``hw`` frame."""
        return self._forward_fn()

    @torch.inference_mode()
    def upscale_frame(self, frame: np.ndarray) -> np.ndarray:
        """One frame x4, whole-frame, never tiled (the reference's ``upVideo``
        contract); honours ``back_projection``."""
        frame = np.asarray(frame)
        x = im2double(self._pre_upscale(torch.tensor(np.ascontiguousarray(frame), device=self.device)))[None]
        y = self._frame_fn(x.shape[1:3])(self._fwd_params(), x)
        out = self._finalize_u8(y[0] * 255.0).cpu().numpy()
        if self.back_projection > 0:
            out = self._back_project(out, frame, self.back_projection)
        return out

    @torch.inference_mode()
    def upscale_video(self, frames: np.ndarray, frame_chunk: int = 1) -> np.ndarray:
        """(T, H, W, 3) uint8 -> (T, 4H, 4W, 3) uint8: the whole-frame forward
        over chunks of ``frame_chunk`` frames; honours ``back_projection``."""
        frames = np.asarray(frames)
        v = torch.tensor(np.ascontiguousarray(frames), device=self.device)
        tc = self._video_chunk(frame_chunk)

        def one(forward, params, chunk):
            return self._finalize_u8(forward(params, im2double(self._pre_upscale(chunk))) * 255.0)

        run = self._jit_replicated(one)
        out = torch.cat([run(self._constrain_frame_batch(v[i : i + tc])) for i in range(0, v.shape[0], tc)])
        out = out.cpu().numpy()
        if self.back_projection > 0:
            out = self._back_project(out, frames, self.back_projection)
        return out

    def upscale_file(self, img_path: str, suffix: str = "scaled", scale_label: int = 1,
                     save_intermediate: bool = False) -> str:
        """Upscale one file into ``output_name``; ``save_intermediate`` also
        writes the classical comparison image, ``resize_pil_uint8`` of the input
        at the output's size, as ``<stem>_intermediate_<ext>`` (``ext`` keeps its dot)."""
        t0 = time.time()
        img = imread(img_path)
        out = self.upscale(img)
        dst = output_name(img_path, suffix, scale_label)
        imwrite(dst, out)
        if save_intermediate:
            stem, ext = os.path.splitext(img_path)
            inter = resize_pil_uint8(torch.from_numpy(np.ascontiguousarray(img)), (out.shape[0], out.shape[1]))
            imwrite(f"{stem}_intermediate_{ext}", inter.numpy().astype(np.uint8))
        log.info(
            "%s (%dx%d) -> %s (%dx%d) in %.2fs",
            os.path.basename(img_path), img.shape[1], img.shape[0],
            os.path.basename(dst), out.shape[1], out.shape[0], time.time() - t0,
        )
        return dst

    def upscale_dir(self, dir_path: str, suffix: str = "scaled", scale_label: int = 1,
                    save_intermediate: bool = False) -> list[str]:
        """Upscale every image of a directory, skipping outputs of earlier runs."""
        outs = []
        tag = f"_{suffix}("
        for path in list_images(dir_path):
            base = os.path.basename(path)
            if tag in base or "_intermediate_" in base:
                continue
            outs.append(self.upscale_file(path, suffix, scale_label, save_intermediate))
        return outs
