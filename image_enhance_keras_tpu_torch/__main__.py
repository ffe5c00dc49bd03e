"""`python -m image_enhance_keras_tpu_torch <cmd>`: the CLI front door (mirror of ``__main__.py``).

  upscale   <dir>  -> cli/main_dirpath.py
  score     <dir>  -> cli/scorpath.py
  learn            -> cli/learn.py
  prepare   <src> <out> -> cli/prepare_data.py
"""

from __future__ import annotations

import sys

_USAGE = """usage: python -m image_enhance_keras_tpu_torch <command> [args]

commands:
  upscale   x4 super-resolve every image in a directory
  score     NTIRE PSNR/SSIM scoring of <stem>_<suffix>(Nx) pairs
  learn     train a model
  prepare   materialise LR/HR patch directories

run `... <command> --help` for options."""


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "upscale":
        from image_enhance_keras_tpu_torch.cli.main_dirpath import main as m
    elif cmd == "score":
        from image_enhance_keras_tpu_torch.cli.scorpath import main as m
    elif cmd == "learn":
        from image_enhance_keras_tpu_torch.cli.learn import main as m
    elif cmd == "prepare":
        from image_enhance_keras_tpu_torch.cli.prepare_data import main as m
    else:
        print(f"unknown command {cmd!r}\n{_USAGE}", file=sys.stderr)
        return 2
    return m(rest)


if __name__ == "__main__":
    sys.exit(main())
