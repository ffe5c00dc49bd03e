"""Scoring CLI (mirror of ``cli/scorpath.py``): walk a directory, pair each
ground truth with its ``<stem>_<suffix>(<k>x)<ext>`` sibling, print per-image
and mean PSNR-Y / SSIM-Y / SSIM-RGB under the NTIRE protocol.

``--generate`` degrades each ground truth by ``--scale-factor``, runs the
model and scores the reconstruction.  It takes every flag of the JAX CLI.

Usage:  python -m image_enhance_keras_tpu_torch.cli.scorpath <dir> [options]
"""

from __future__ import annotations

import argparse
import json
import sys

#: the model registry (``models/zoo.py``)
_MODELS = ("didbl", "didbl_subpixel", "difv4", "difv4_x2", "difvdsr")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="NTIRE PSNR/SSIM scoring (PyTorch/CUDA)")
    p.add_argument("path_dir", nargs="?", default="val_images/set5nitre")
    p.add_argument("--suffix", default="scaled")
    p.add_argument("--scale", default=1, type=int, help="scale label in prediction names")
    p.add_argument("--crop", default=10, type=int, help="border crop (reference: 10)")
    p.add_argument("--json", default=None, help="write means to this JSON file")
    p.add_argument("--gmsd", action="store_true",
                   help="also report GMSD-Y (perceptual gradient metric, lower=better)")
    p.add_argument("--allow-shape-mismatch", action="store_true",
                   help="score the top-left common region of mismatched pairs instead of erroring")
    p.add_argument("--generate", action="store_true",
                   help="degrade+reconstruct with --model instead of reading saved outputs")
    p.add_argument("--model", default="didbl", choices=_MODELS)
    p.add_argument("--weights", default=None,
                   help="params .npz; omitted = the model's committed demo checkpoint; "
                        "'none' = explicit random-init smoke run")
    p.add_argument("--scale-factor", default=4, type=int)
    p.add_argument("--forward", default="xla",
                   choices=["xla", "int8", "pallas", "pallas_chain", "pallas_int8"],
                   help="with --generate: forward implementation (xla: the plain torch module; "
                        "int8 / pallas / pallas_chain / pallas_int8: the CUDA kernels)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16", "mixed"],
                   help="with --generate: serving precision (mixed: bf16 conv operands, float32 "
                        "emission)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (cuda must be present unless cpu is asked for)")
    p.add_argument("--self-ensemble", action="store_true",
                   help="with --generate: x8 geometric self-ensemble forwards")
    p.add_argument("--back-projection", type=int, default=0, metavar="N",
                   help="with --generate: N iterative back-projection steps")
    p.add_argument("--internal-learn", type=int, default=0, metavar="N",
                   help="with --generate: per-image test-time adaptation, N steps on the input itself")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.generate:
        from image_enhance_keras_tpu_torch.cli.common import resolve_cli_weights
        from image_enhance_keras_tpu_torch.engine import SuperResolver
        from image_enhance_keras_tpu_torch.eval import evaluate_model

        resolver = SuperResolver(model=args.model, weights=resolve_cli_weights(args.model, args.weights),
                                 self_ensemble=args.self_ensemble, back_projection=args.back_projection,
                                 forward=args.forward, dtype=None if args.dtype == "float32" else "bfloat16",
                                 mixed=args.dtype == "mixed", internal_learn=args.internal_learn,
                                 device=args.device)
        scores, means = evaluate_model(resolver, args.path_dir, scale=args.scale_factor,
                                       crop_border=args.crop, with_gmsd=args.gmsd)
    else:
        from image_enhance_keras_tpu_torch.eval import score_directory

        try:
            scores, means = score_directory(
                args.path_dir, suffix=args.suffix, scale_label=args.scale, crop_border=args.crop,
                allow_shape_mismatch=args.allow_shape_mismatch, with_gmsd=args.gmsd,
                device=args.device,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.json and means:
        with open(args.json, "w") as f:
            json.dump(means, f, indent=2)
    return 0 if scores else 1


if __name__ == "__main__":
    sys.exit(main())
