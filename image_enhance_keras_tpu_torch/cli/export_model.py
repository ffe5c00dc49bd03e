"""Export CLI (mirror of ``cli/export_model.py``): serialize a serving program as an artifact.

    python -m image_enhance_keras_tpu_torch.cli.export_model out.iekx \
        --model didbl --weights weights_Double/didbl_set5demo.npz --hw 512 512

The artifact holds the program and its weights (``runtime/export.py``,
``torch.export``); load it with ``runtime.export.load_forward``, which
needs torch and the op library only.  One artifact per input-size bucket,
on the device it was exported on (``--device``).
"""

from __future__ import annotations

import argparse
import sys

from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="export a serving program (torch.export)")
    p.add_argument("out", help="artifact path (.iekx)")
    p.add_argument("--model", default="didbl", choices=sorted(MODEL_REGISTRY))
    p.add_argument("--weights", default=None)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--forward", default="xla",
                   choices=["xla", "int8", "pallas", "pallas_chain", "pallas_int8"])
    p.add_argument("--hw", nargs=2, type=int, default=[512, 512],
                   metavar=("H", "W"), help="input size bucket")
    p.add_argument("--mode", default="fast", choices=["fast", "split", "patch"],
                   help="serving program to export (split + --split-tile-w = "
                        "the bounded-memory 2-D tiled production mode)")
    p.add_argument("--split-tile", type=int, default=128)
    p.add_argument("--split-tile-w", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the program runs (cuda must be present unless cpu is asked for)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from image_enhance_keras_tpu_torch.cli.common import resolve_cli_weights
    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.runtime.export import export_pipeline

    resolver = SuperResolver(
        model=args.model,
        weights=resolve_cli_weights(args.model, args.weights),
        dtype="bfloat16" if args.dtype == "bfloat16" else None,
        forward=args.forward,
        mode=args.mode,
        split_tile=args.split_tile,
        split_tile_w=args.split_tile_w,
        device=args.device,
    )
    n = export_pipeline(resolver, tuple(args.hw), args.out)
    tiling = f" tile {args.split_tile}" + (
        f"x{args.split_tile_w}" if args.split_tile_w else ""
    ) if args.mode == "split" else ""
    print(f"wrote {args.out}: {n / 1e6:.1f} MB "
          f"({args.model} {args.hw[0]}x{args.hw[1]} {args.dtype} "
          f"{args.forward} {args.mode}{tiling})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
