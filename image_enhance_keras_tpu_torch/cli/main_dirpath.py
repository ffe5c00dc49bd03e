"""Directory inference CLI (mirror of ``cli/main_dirpath.py``).

x4-upscales every image of a directory into ``<stem>_<suffix>(<scale>x)<ext>``
beside it, one image after another, or with ``--pipeline`` through the
overlapped decode / device / encode pipeline (``runtime/serving.py``).
``--save_intermediate`` also writes ``<stem>_intermediate_<ext>``, the
input PIL-bicubic resized to the output's size (serial loop only).  The JAX
CLI's flags all parse.  ``--devices N`` above 1 serves through
``parallel.ShardedResolver`` over N devices: ``cuda:0 .. cuda:N-1`` (more
than the machine has raises), or with ``--device cpu`` N entries of the CPU.

Usage:  python -m image_enhance_keras_tpu_torch.cli.main_dirpath <imgdir> [options]
"""

from __future__ import annotations

import argparse
import os
import sys

from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY
from image_enhance_keras_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="x4 super-resolve every image in a directory (PyTorch/CUDA)")
    p.add_argument("imgpath", help="directory of images to upscale")
    p.add_argument("--model", default="didbl", choices=sorted(MODEL_REGISTRY))
    p.add_argument("--scale", default=1, type=int, help="scale label used in output names")
    p.add_argument("--mode", default="patch", choices=["fast", "patch", "split"],
                   help="patch: reference-exact overlapped tiling; fast: whole-frame forward; "
                        "split: whole-frame body + halo-striped tail (fast's output, bounded memory)")
    p.add_argument("--forward", default="xla",
                   choices=["xla", "int8", "pallas", "pallas_chain", "pallas_int8"],
                   help="xla: the plain torch module; int8: every residual block on the "
                        "per-channel int8 CUDA kernels, the production serving profile; "
                        "pallas: LR blocks on the CUDA kernels; "
                        "pallas_chain: the LR blocks as two chain kernels; "
                        "pallas_int8: every residual block on the per-tensor int8 CUDA kernels")
    p.add_argument("--suffix", default="scaled", help="suffix of output images")
    p.add_argument("--patch_size", default=96, type=int, help="tile size (reference: 96)")
    p.add_argument("--step", default=64, type=int, help="tile step (reference: 64)")
    p.add_argument("--geometry", default=None, choices=["ref", "perf"],
                   help="tile geometry preset (overrides patch_size/step)")
    p.add_argument("--weights", default=None,
                   help="params .npz; omitted = the model's committed demo checkpoint; "
                        "'none' = explicit random-init smoke run")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16", "mixed", "mixed-tail"],
                   help="serving precision: float32; bfloat16; mixed (bf16 conv operands, float32 "
                        "emission); mixed-tail (pure-bf16 body, mixed tail); the pallas forwards run "
                        "the mixed profiles in bf16, the int8 forwards ignore the dtype")
    p.add_argument("--tile_chunk", default=16, type=int)
    p.add_argument("--round-mode", default="round", choices=["round", "trunc"],
                   help="final uint8 cast: round (half to even) or trunc (the reference's cast)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (cuda must be present unless cpu is asked for)")
    p.add_argument("--int8-calib-dir", default=None,
                   help="int8 forwards: calibrate activation scales on these images "
                        "(default: the package-bundled photos, else procedural images)")
    p.add_argument("--split-tile", type=int, default=None,
                   help="split-mode row stripe / tile height in body-map px (default 64)")
    p.add_argument("--split-tile-w", type=int, default=None,
                   help="2-D tiled tail: also tile split-mode columns (body-map px)")
    p.add_argument("--int8-acc", default=None, choices=["bf16", "s32", "f32"],
                   help="--forward int8: the conv accumulator's type before the dequant "
                        "(default bf16; s32 and f32 keep the exact sum)")
    p.add_argument("--int8-emit", default=None, choices=["wide", "s8"],
                   help="--forward int8: branch-intermediate emission (s8: the fused "
                        "requantization; bit-equal to wide)")
    p.add_argument("--self-ensemble", action="store_true",
                   help="x8 geometric self-ensemble (flips and rot90 averaged)")
    p.add_argument("--back-projection", type=int, default=0, metavar="N",
                   help="N iterative back-projection steps against the LR input")
    p.add_argument("--internal-learn", type=int, default=0, metavar="N",
                   help="per-image test-time adaptation: fine-tune a copy of the weights for N steps "
                        "on pairs built from the input itself before upscaling it")
    p.add_argument("--internal-learn-lr", type=float, default=None,
                   help="adaptation learning rate (default 2e-5)")
    p.add_argument("--save_intermediate", default=False, action="store_true",
                   help="also write <stem>_intermediate_<ext>: the input PIL-bicubic resized to the output size")
    p.add_argument("--devices", default=1, type=int,
                   help="shard tiles (or a frame's rows) across this many devices (data-parallel inference)")
    p.add_argument("--pipeline", action="store_true",
                   help="overlap decode / device / encode (native threaded IO)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    # the int8 knobs are read from the environment at call time: scope them to
    # this run, so that an in-process caller's next main() sees the defaults
    saved = {k: os.environ.get(k) for k in ("IEK_INT8_ACC", "IEK_INT8_EMIT")}
    if args.int8_acc:
        os.environ["IEK_INT8_ACC"] = args.int8_acc
    if args.int8_emit:
        os.environ["IEK_INT8_EMIT"] = args.int8_emit
    try:
        return _run(args)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run(args) -> int:
    from image_enhance_keras_tpu_torch.cli.common import resolve_cli_weights

    weights = resolve_cli_weights(args.model, args.weights)
    if args.devices > 1:
        from image_enhance_keras_tpu_torch.parallel import ShardedResolver as Resolver

        sharding = {"n_devices": args.devices}
    else:
        from image_enhance_keras_tpu_torch.engine import SuperResolver as Resolver

        sharding = {}
    resolver = Resolver(
        model=args.model,
        weights=weights,
        dtype="bfloat16" if args.dtype == "bfloat16" else None,
        patch=args.patch_size,
        step=args.step,
        geometry=args.geometry,
        tile_chunk=args.tile_chunk,
        mode=args.mode,
        forward=args.forward,
        split_tile_w=args.split_tile_w,
        **({"split_tile": args.split_tile} if args.split_tile else {}),
        self_ensemble=args.self_ensemble,
        back_projection=args.back_projection,
        round_mode=args.round_mode,
        mixed="tail" if args.dtype == "mixed-tail" else args.dtype == "mixed",
        internal_learn=args.internal_learn,
        device=args.device,
        **sharding,
    )
    if args.int8_calib_dir:
        resolver.int8_calib_dir = args.int8_calib_dir
    if args.internal_learn_lr is not None:
        resolver.internal_learn_lr = args.internal_learn_lr
    if args.pipeline:
        from image_enhance_keras_tpu_torch.runtime.serving import serve_directory

        if args.save_intermediate:
            log.warning("--save_intermediate is not supported by the overlapped --pipeline path; no "
                        "intermediate images will be written")
        stats = serve_directory(resolver, args.imgpath, suffix=args.suffix, scale_label=args.scale)
        log.info("wrote %d images (%.2f out-Mpix/s incl. IO)", stats.images, stats.out_mpix_s)
        return 0
    outs = resolver.upscale_dir(args.imgpath, suffix=args.suffix, scale_label=args.scale,
                                save_intermediate=args.save_intermediate)
    log.info("wrote %d images", len(outs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
