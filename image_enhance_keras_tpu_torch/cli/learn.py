"""Training CLI (mirror of ``cli/learn.py``).

    python -m image_enhance_keras_tpu_torch.cli.learn [--train-dir DIR] [--val-dir DIR]
        [--model didbl] [--epochs 180] ... [--device cuda|cpu]

Trains any zoo model with the on-device degradation; with no data dirs it
runs a synthetic smoke fit.  Every flag of the JAX CLI parses with the same
default; ``--device`` is the port's own (``cuda`` unless the CPU is asked
for).  ``--devices N`` above 1 trains data-parallel over
``parallel.make_mesh(N)`` (``cuda:0 .. cuda:N-1``; N entries of the CPU with
``--device cpu``); the batch size must be a multiple of N.  As in the JAX
CLI, a job of several processes is joined by the program that calls
``main`` (``parallel.maybe_init_distributed``), not by the CLI.
"""

from __future__ import annotations

import argparse
import sys

from image_enhance_keras_tpu_torch.utils.config import Config
from image_enhance_keras_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train a super-resolution model (PyTorch/CUDA)")
    p.add_argument("--model", default="didbl")
    p.add_argument("--train-dir", default=None, help="directory of HR training images")
    p.add_argument("--val-dir", default=None)
    p.add_argument("--epochs", type=int, default=180)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--steps-per-epoch", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-patch", type=int, default=24)
    p.add_argument("--checkpoint-dir", default="weights_Double")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--devices", type=int, default=1, help="data-parallel devices")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--augment", action="store_true", help="random flips/transpose")
    p.add_argument("--moa", type=float, default=0.0, metavar="P",
                   help="mixture-of-augmentations: per-sample probability of one of blend/rgb_perm/"
                        "mixup/cutmix/cutmixup on the HR patch before the degradation. 0 = off")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="epochs between checkpoint writes (final always saved)")
    p.add_argument("--clip-norm", type=float, default=None, help="global-norm gradient clipping")
    p.add_argument("--lr-schedule", default="constant", choices=["constant", "cosine"])
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="exponential moving average of params (e.g. 0.999); val metrics score the EMA "
                        "weights, exported to <ckpt-dir>/best_ema.npz")
    p.add_argument("--blur-sigma", type=float, default=0.5,
                   help="training degradation blur sigma (0: plain bicubic, the scoring protocol's)")
    p.add_argument("--loss", default="mse", choices=["mse", "charbonnier", "l1"],
                   help="pixel loss: mse (the reference's), charbonnier or l1")
    p.add_argument("--monitor", default="val_ssim_y", choices=["val_ssim_y", "val_psnr_y", "val_psnr", "val_loss"],
                   help="best-checkpoint metric; val_ssim_y = the full-image scoring-protocol gate (default)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="add N procedural training images (textured dead-leaves, 1/f noise); colors "
                        "are sampled from --train-dir images when given")
    p.add_argument("--builtin-photos", action="store_true",
                   help="add the bundled real photographs (data/photos) to the real side of the corpus")
    p.add_argument("--fibers", action="store_true",
                   help="with --synthetic: a quarter of the corpus as hair/fur-like fiber textures")
    p.add_argument("--real-mass", type=float, default=0.5, metavar="F",
                   help="with --train-dir AND --synthetic: fraction of patch samples drawn from the "
                        "real images (default 0.5)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train (cuda must be present unless cpu is asked for)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = Config(
        model=args.model,
        dtype=args.dtype,
        lr=args.lr,
        batch_size=args.batch_size,
        epochs=args.epochs,
        steps_per_epoch=args.steps_per_epoch,
        lr_patch=args.lr_patch,
        checkpoint_dir=args.checkpoint_dir,
        augment=args.augment,
        moa=args.moa,
        ckpt_every=args.ckpt_every,
        clip_norm=args.clip_norm,
        lr_schedule=args.lr_schedule,
        ema_decay=args.ema_decay,
        loss=args.loss,
        monitor=args.monitor,
        blur_sigma=args.blur_sigma,
    )
    from image_enhance_keras_tpu_torch.data.pipeline import load_image_dir
    from image_enhance_keras_tpu_torch.train.trainer import Trainer

    train_images = load_image_dir(args.train_dir) if args.train_dir else None
    val_images = load_image_dir(args.val_dir) if args.val_dir else None
    train_weights = None
    if args.builtin_photos:
        from image_enhance_keras_tpu_torch.data.pipeline import builtin_photos

        photos = builtin_photos()
        if not photos:
            raise SystemExit("--builtin-photos: no bundled photos found")
        train_images = (train_images or []) + photos
    if args.synthetic:
        from image_enhance_keras_tpu_torch.data.pipeline import pinned_mass_weights, rich_synthetic_images

        synth = rich_synthetic_images(args.synthetic, 256, seed=0, palette_images=train_images,
                                      fibers=args.fibers)
        if train_images:
            train_weights = pinned_mass_weights(len(train_images), len(synth), args.real_mass)
        train_images = (train_images or []) + synth
    mesh = None
    if args.devices > 1:
        from image_enhance_keras_tpu_torch.parallel import make_mesh

        mesh = make_mesh(args.devices, devices=["cpu"] * args.devices if args.device == "cpu" else None)
    trainer = Trainer(cfg, train_images, val_images, mesh=mesh, train_weights=train_weights, device=args.device)
    if args.resume:
        trainer.resume()
    trainer.fit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
