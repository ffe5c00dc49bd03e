"""The typed run configuration (mirror of ``utils/config.py``).

Same fields and defaults as the JAX package's ``Config``, so a JSON config
written by either package loads in the other; ``torch_dtype`` takes the
place of ``jax_dtype``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

__all__ = ["Config"]


@dataclasses.dataclass
class Config:
    # model
    model: str = "didbl"
    dtype: str = "float32"  # "bfloat16" for the serving profile
    weights: str | None = None
    # extra kwargs forwarded to the model constructor (e.g. narrow block
    # configs for smoke runs: {"features": 8, "n_mid": 1})
    model_kwargs: dict = dataclasses.field(default_factory=dict)

    # tiled inference (the reference's 96/64/8)
    patch: int = 96
    step: int = 64
    crop: int = 8
    scalemulti: int = 4
    tile_chunk: int = 16

    # training (the reference's Adam lr 1e-4, beta1 0.9, MSE)
    lr: float = 1e-4
    beta1: float = 0.9
    batch_size: int = 10
    epochs: int = 180
    steps_per_epoch: int = 256
    lr_patch: int = 24  # LR patch side; HR = lr_patch * scale
    blur_sigma: float = 0.5  # degradation blur
    augment: bool = False  # random flips/transpose on HR patches
    # mixture-of-augmentations probability per sample (data/augment.py); 0 = off
    moa: float = 0.0
    ckpt_every: int = 1  # epochs between checkpoint writes (final epoch always)
    clip_norm: float | None = None  # global-norm gradient clipping
    lr_schedule: str = "constant"  # "constant" | "cosine" (decay over the run)
    # pixel loss: "mse" (the reference's), "charbonnier" (sqrt(d^2+eps^2)) or "l1"
    loss: str = "mse"
    charbonnier_eps: float = 1e-3
    # exponential moving average of params (0 disables); when on, the val
    # metrics and best-checkpoint selection score the EMA weights, exported
    # as <checkpoint_dir>/{best,latest}_ema.npz
    ema_decay: float = 0.0
    checkpoint_dir: str = "weights_Double"
    seed: int = 0
    # best-checkpoint metric: patch-level "val_psnr" / "val_loss" or the
    # full-image scoring-protocol "val_ssim_y" / "val_psnr_y"
    monitor: str = "val_psnr"
    image_eval: bool = False  # compute full-image metrics even if not monitored

    # eval (the scorpath protocol)
    eval_crop_border: int = 10
    eval_suffix: str = "scaled"

    def torch_dtype(self):
        """The model profile's dtype: None (float32) or torch.bfloat16."""
        import torch

        return {"float32": None, "bfloat16": torch.bfloat16}[self.dtype]

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as f:
            return cls(**json.load(f))

    def override(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **{k: v for k, v in kw.items() if v is not None})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
