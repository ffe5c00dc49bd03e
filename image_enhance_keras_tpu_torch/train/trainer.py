"""The trainer (mirror of ``train/trainer.py``).

Contract kept from the reference and the JAX package: Adam (lr 1e-4, beta1
0.9) on a pixel loss over [0,1] floats, per-epoch validation with
best-checkpoint selection, history written every epoch, full-state
checkpoints for a true resume.  One train step degrades the uint8 HR batch
on the device, runs the zoo's ``nn.Module`` forward, the loss and its
gradient, and the update: on a CUDA device the forward's TF1 upsample is
the CUDA kernel (``ops/cuda/upsample.py``), its gradient the autograd of
the plain construction, as JAX transposes its XLA construction.

The optimizer follows optax's arithmetic, not ``torch.optim.Adam``'s:
``optax.adam(lr, b1)`` (eps 1e-8 outside the square root, bias correction
by the incremented count, the learning rate, or the cosine schedule at the
count before the increment, applied last), behind
``optax.clip_by_global_norm`` when ``clip_norm`` is set, over the trainable
parameters only (:func:`mask_frozen`).  Every scalar it multiplies or
divides by is a float32 tensor on the parameters' device.

Data-parallel training (``Trainer(mesh=)``, ``make_train_step(mesh=)``):
each global batch is cut into one shard per device of the mesh (a batch
the device count does not divide raises); each device runs the
degradation, the forward and the loss on its shard with its replica of the
module; the gradients are combined into the gradient of the global-batch
mean once, on the first device, which runs the clip, the frozen mask,
Adam and the EMA, and the updated parameters are copied back to every
replica.  Across the processes of a ``torch.distributed`` group
(``parallel.distributed.maybe_init_distributed``) each rank samples its
own batch (seed ``seed + 7919 * rank``), the global batch being the ranks'
batches in rank order: the gradients (and the metrics) are summed by one
``all_reduce`` and scaled to the global mean, rank 0 alone writes the
checkpoints and ``history.json`` (the others wait at a barrier), and every
rank restores.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from image_enhance_keras_tpu_torch.data.pipeline import PatchSampler, degrade_batch_on_device, synthetic_images
from image_enhance_keras_tpu_torch.models.weights import load_params
from image_enhance_keras_tpu_torch.models.zoo import get_model, init_params
from image_enhance_keras_tpu_torch.ops.color import im2double
from image_enhance_keras_tpu_torch.train.callbacks import HistoryLogger
from image_enhance_keras_tpu_torch.train.checkpoints import CheckpointManager, export_params_npz
from image_enhance_keras_tpu_torch.utils.config import Config
from image_enhance_keras_tpu_torch.utils.logging import get_logger

__all__ = [
    "Adam",
    "Replicas",
    "TrainState",
    "Trainer",
    "cosine_decay_schedule",
    "make_eval_step",
    "make_image_metric_step",
    "make_train_step",
    "mask_frozen",
    "pixel_loss_fn",
]

log = get_logger(__name__)


def _path(name: str) -> str:
    """``body53_0.conv_a1.kernel`` -> the flax path ``body53_0/conv_a1/kernel``."""
    return name.replace(".", "/")


def _f32(v: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: count -> learning rate, in float32."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs positive decay_steps, got {decay_steps}")
    f = np.float32

    def schedule(count: int) -> float:
        c = f(min(float(count), float(decay_steps)))
        cosine = f(0.5) * (f(1.0) + np.cos(f(np.pi) * c / f(decay_steps)))
        return float(f(init_value) * (f(1.0 - alpha) * cosine + f(alpha)))

    return schedule


class Adam:
    """``optax.adam(lr, b1)`` (b2 0.999, eps 1e-8, eps_root 0), behind
    ``optax.clip_by_global_norm(clip_norm)`` when ``clip_norm`` is set, over
    ``params`` (flax path -> parameter) and nothing else: those parameters'
    ``.grad`` in, an in-place update out.

    ``lr`` is a float or a schedule (count -> float), evaluated at the count
    before the increment.  The global norm of the clip runs over ``params``
    only, as optax's ``multi_transform`` hands the chained clip only the
    trainable leaves.
    """

    b2, eps = 0.999, 1e-8

    def __init__(self, params: dict[str, nn.Parameter], lr: float | Callable[[int], float], b1: float = 0.9,
                 clip_norm: float | None = None):
        self.params = params
        self.lr = lr
        self.b1 = b1
        self.clip_norm = clip_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(p, memory_format=torch.contiguous_format) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p, memory_format=torch.contiguous_format) for k, p in params.items()}

    def learning_rate(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        if not self.params:
            return
        dev = next(iter(self.params.values())).device
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in self.params.items()}
        if self.clip_norm:
            sq = None
            for g in grads.values():
                s = torch.sum(g * g)
                sq = s if sq is None else sq + s
            g_norm = torch.sqrt(sq)
            max_norm = _f32(self.clip_norm, dev)
            keep = g_norm < max_norm
            grads = {k: torch.where(keep, g, (g / g_norm) * max_norm) for k, g in grads.items()}
        b1, b2 = _f32(self.b1, dev), _f32(self.b2, dev)
        c1, c2 = _f32(1 - self.b1, dev), _f32(1 - self.b2, dev)
        count_inc = self.count + 1
        one = _f32(1.0, dev)
        bc1 = one - b1 ** count_inc
        bc2 = one - b2 ** count_inc
        eps = _f32(self.eps, dev)
        step_size = _f32(-self.learning_rate(self.count), dev)
        for k, p in self.params.items():
            g = grads[k]
            mu = c1 * g + b1 * self.mu[k]
            nu = c2 * (g * g) + b2 * self.nu[k]
            self.mu[k], self.nu[k] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            p.add_(step_size * u)
        self.count = count_inc

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        if set(state["mu"]) != set(self.params):
            raise ValueError(f"optimizer state covers {sorted(state['mu'])[:4]}..., not the trained parameters")
        self.count = int(state["count"])
        for k, p in self.params.items():
            self.mu[k] = state["mu"][k].to(p.device, p.dtype)
            self.nu[k] = state["nu"][k].to(p.device, p.dtype)


@dataclasses.dataclass
class TrainState:
    """The module (its parameters), the optimizer (its moments and count),
    the step count and the EMA shadow of the parameters (flax path ->
    tensor; None when disabled)."""

    module: nn.Module
    opt: Adam
    step: int = 0
    ema: dict[str, torch.Tensor] | None = None

    def params(self) -> dict[str, torch.Tensor]:
        """flax path -> parameter (detached, sharing the module's storage)."""
        return {_path(k): p.detach() for k, p in self.module.named_parameters()}

    def state_dict(self) -> dict:
        return {"params": self.params(), "opt_state": self.opt.state_dict(), "step": self.step, "ema": self.ema}

    def load_state_dict(self, state: dict) -> None:
        load_params(self.module, state["params"])
        self.opt.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        if state.get("ema") is not None:
            dev = next(self.module.parameters()).device
            self.ema = {k: v.to(dev) for k, v in state["ema"].items()}


def pixel_loss_fn(kind: str, eps: float = 1e-3) -> Callable:
    """Pixel loss by name: "mse" (the reference's), "charbonnier"
    (sqrt(d^2 + eps^2)) or "l1"; each a mean over the batch."""
    if kind == "mse":
        return lambda pred, y: torch.mean((pred - y) ** 2)
    if kind == "charbonnier":
        e2 = float(eps) ** 2
        return lambda pred, y: torch.mean(torch.sqrt((pred - y) ** 2 + e2))
    if kind == "l1":
        return lambda pred, y: torch.mean(torch.abs(pred - y))
    raise ValueError(f"unknown loss {kind!r}: expected mse|charbonnier|l1")


def mask_frozen(module: nn.Module) -> dict[str, nn.Parameter]:
    """The parameters the optimizer trains, by flax path: all of the
    module's but those under its ``frozen_params`` groups (difvdsr's entry
    conv, the reference's trainable=False).  Those are set
    ``requires_grad=False``: no gradient, no optimizer state, exactly zero
    update."""
    frozen = tuple(getattr(module, "frozen_params", ()) or ())
    out = {}
    for name, p in module.named_parameters():
        if name.split(".")[0] in frozen:
            p.requires_grad_(False)
        else:
            p.requires_grad_(True)
            out[_path(name)] = p
    return out


def _net_input(lr_x: torch.Tensor, scale: int, pre_upscale: bool) -> torch.Tensor:
    """Pre-upscaled-input models (difvdsr) refine a PIL-bicubic x``scale`` of the LR input."""
    if not pre_upscale:
        return lr_x
    from image_enhance_keras_tpu_torch.ops.resize import resize_bicubic_pil

    return resize_bicubic_pil(lr_x, (lr_x.shape[-3] * scale, lr_x.shape[-2] * scale))


def _ema_update(state: "TrainState", ema_decay: float, device: torch.device) -> None:
    if ema_decay > 0.0 and state.ema is not None:
        d = _f32(ema_decay, device)
        one_minus = 1.0 - d
        for k, p in state.params().items():
            state.ema[k] = d * state.ema[k] + one_minus * p.to(state.ema[k].dtype)


def _process_group():
    """The ``torch.distributed`` module when this process is in a group, else None."""
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


class Replicas:
    """Copies of a module on the other devices of a mesh, made once and set
    equal to the module (:meth:`sync`) after each update."""

    def __init__(self):
        self._copies: dict[torch.device, tuple[nn.Module, nn.Module]] = {}

    def on(self, module: nn.Module, device: torch.device) -> nn.Module:
        """``module`` itself on its own device, else its copy on ``device``."""
        if device == next(module.parameters()).device:
            return module
        hit = self._copies.get(device)
        if hit is None or hit[0] is not module:
            hit = (module, copy.deepcopy(module).to(device))
            for p in hit[1].parameters():
                p.grad = None
            self._copies[device] = hit
        return hit[1]

    @torch.no_grad()
    def sync(self, module: nn.Module) -> None:
        """Copy ``module``'s parameters into each of its replicas."""
        for src, dst in self._copies.values():
            if src is module:
                for a, b in zip(dst.parameters(), module.parameters()):
                    a.copy_(b)


def _shards(hr_u8: torch.Tensor, devices: list[torch.device]) -> list[torch.Tensor]:
    n = int(hr_u8.shape[0])
    if n % len(devices):
        raise ValueError(f"a batch of {n} does not divide over the mesh's {len(devices)} devices")
    return list(torch.split(hr_u8, n // len(devices)))


def _global_mean(parts: list, device: torch.device) -> list[torch.Tensor]:
    """Per-shard lists of tensors -> their means over the shards on ``device``,
    then over the ranks of the process group (one ``all_reduce`` of them all)."""
    n = _f32(len(parts), device)
    means = [torch.stack([p[i].to(device) for p in parts]).sum(0) / n for i in range(len(parts[0]))]
    dist = _process_group()
    if dist is not None:
        flat = torch.cat([m.reshape(-1) for m in means])
        dist.all_reduce(flat)
        flat = flat / _f32(dist.get_world_size(), device)
        means = [v.view_as(m) for v, m in zip(torch.split(flat, [m.numel() for m in means]), means)]
    return means


def make_train_step(scale: int, blur_sigma: float, pre_upscale: bool = False, ema_decay: float = 0.0,
                    loss: str = "mse", charbonnier_eps: float = 1e-3, mesh=None) -> Callable:
    """step(state, hr_u8) -> (state, metrics): degrade, forward, loss,
    gradient, optimizer update and (``ema_decay`` > 0, ``state.ema`` set)
    the EMA, in place on the state's module, optimizer and EMA.  ``hr_u8``
    is a uint8 (B, H, W, 3) tensor on the module's device.  The metrics
    stay on the device: "loss", and "psnr" from the MSE whatever the loss.

    With ``mesh``: the data-parallel step (the module docstring); ``hr_u8``
    is this process's batch, on any device, and ``step.replicas`` holds the
    module's copies on the mesh's other devices."""
    config = dict(scale=scale, blur_sigma=blur_sigma, pre_upscale=pre_upscale, ema_decay=ema_decay, loss=loss,
                  charbonnier_eps=charbonnier_eps)
    objective = pixel_loss_fn(loss, charbonnier_eps)

    def step(state: TrainState, hr_u8: torch.Tensor):
        lr_x = degrade_batch_on_device(hr_u8, scale=scale, blur_sigma=blur_sigma)
        hr_y = im2double(hr_u8)
        state.opt.zero_grad()
        with torch.enable_grad():
            pred = state.module(_net_input(lr_x, scale, pre_upscale))
            value = objective(pred, hr_y)
            value.backward()
        state.opt.step()
        with torch.no_grad():
            _ema_update(state, ema_decay, hr_y.device)
            psnr = -10.0 * torch.log10(torch.mean((pred - hr_y) ** 2))
        state.step += 1
        return state, {"loss": value.detach(), "psnr": psnr}

    def dp_step(state: TrainState, hr_u8: torch.Tensor):
        devices = mesh.local_devices()
        names = list(state.opt.params)
        parts = []
        for shard, dev in zip(_shards(hr_u8, devices), devices):
            module = replicas.on(state.module, dev)
            own = {_path(k): p for k, p in module.named_parameters()}
            x = shard.to(dev)
            lr_x = degrade_batch_on_device(x, scale=scale, blur_sigma=blur_sigma)
            hr_y = im2double(x)
            with torch.enable_grad():
                pred = module(_net_input(lr_x, scale, pre_upscale))
                value = objective(pred, hr_y)
                grads = torch.autograd.grad(value, [own[k] for k in names])
            with torch.no_grad():
                parts.append([*grads, value.detach(), torch.mean((pred - hr_y) ** 2)])
        dev0 = devices[0]
        with torch.no_grad():
            *grads, value, mse = _global_mean(parts, dev0)
        for k, g in zip(names, grads):
            state.opt.params[k].grad = g
        state.opt.step()
        with torch.no_grad():
            _ema_update(state, ema_decay, dev0)
            replicas.sync(state.module)
            psnr = -10.0 * torch.log10(mse)
        state.step += 1
        return state, {"loss": value, "psnr": psnr}

    if mesh is None:
        step.config = config
        return step
    replicas = Replicas()
    dp_step.config = config
    dp_step.replicas = replicas
    return dp_step


def make_eval_step(scale: int, blur_sigma: float, pre_upscale: bool = False, mesh=None) -> Callable:
    """step(forward, hr_u8) -> {"val_loss", "val_psnr"} on the training
    degradation; ``forward`` maps the net input to the prediction.  With
    ``mesh``: the batch sharded as the train step shards it, ``forward`` a
    function of the device giving the forward there, the metrics of the
    global batch."""

    @torch.no_grad()
    def step(forward, hr_u8: torch.Tensor):
        lr_x = degrade_batch_on_device(hr_u8, scale=scale, blur_sigma=blur_sigma)
        mse = torch.mean((forward(_net_input(lr_x, scale, pre_upscale)) - im2double(hr_u8)) ** 2)
        return {"val_loss": mse, "val_psnr": -10.0 * torch.log10(mse)}

    @torch.no_grad()
    def dp_step(forward_on, hr_u8: torch.Tensor):
        devices = mesh.local_devices()
        parts = []
        for shard, dev in zip(_shards(hr_u8, devices), devices):
            x = shard.to(dev)
            lr_x = degrade_batch_on_device(x, scale=scale, blur_sigma=blur_sigma)
            parts.append([torch.mean((forward_on(dev)(_net_input(lr_x, scale, pre_upscale)) - im2double(x)) ** 2)])
        (mse,) = _global_mean(parts, devices[0])
        return {"val_loss": mse, "val_psnr": -10.0 * torch.log10(mse)}

    out = step if mesh is None else dp_step
    out.config = dict(scale=scale, blur_sigma=blur_sigma, pre_upscale=pre_upscale)
    return out


def make_image_metric_step(scale: int, pre_upscale: bool = False) -> Callable:
    """Full-image eval under the scoring protocol (``cli/scorpath.py``):
    PIL-bicubic degrade with no blur, whole-frame forward, 10-px crop,
    Y-channel PSNR and SSIM; step(forward, gt_u8) for a uint8 (H, W, 3)
    tensor whose sides are multiples of ``scale``."""
    from image_enhance_keras_tpu_torch.ops.color import rgb2ycbcr
    from image_enhance_keras_tpu_torch.ops.metrics import psnr_nitre, ssim
    from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8

    @torch.no_grad()
    def step(forward, gt_u8: torch.Tensor):
        h, w = gt_u8.shape[0], gt_u8.shape[1]
        lr = resize_pil_uint8(gt_u8, (h // scale, w // scale))
        if pre_upscale:
            lr = resize_pil_uint8(lr, (h, w))
        sr = forward(im2double(lr)[None])[0]
        sr = torch.clamp(torch.round(sr * 255.0), 0.0, 255.0)
        gt = gt_u8.to(torch.float32)[10:-10, 10:-10]
        sr = sr[10:-10, 10:-10]
        gt_y = rgb2ycbcr(gt)[..., 0]
        sr_y = rgb2ycbcr(sr)[..., 0]
        return {"val_psnr_y": psnr_nitre(sr_y, gt_y, 0), "val_ssim_y": ssim(sr_y, gt_y, data_range=255.0)}

    return step


class Trainer:
    """Single-device or data-parallel trainer for any zoo model.

    ``params`` (a nested dict of arrays or tensors by flax path, e.g. a
    loaded npz) replaces the seeded random init; ``device`` is ``cuda``
    unless the CPU is asked for; ``mesh`` (``parallel.make_mesh``) trains
    data-parallel over its devices, the first of which holds the state.
    """

    def __init__(self, config: Config | None = None, train_images: list[np.ndarray] | None = None,
                 val_images: list[np.ndarray] | None = None, mesh=None,
                 train_weights: list[float] | None = None, params: Any = None,
                 device: str | torch.device = "cuda"):
        from image_enhance_keras_tpu_torch.engine import disable_tf32, resolve_device
        from image_enhance_keras_tpu_torch.parallel.mesh import Mesh

        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
            device = mesh.local_devices()[0]
        self.mesh = mesh
        self.device = resolve_device(device)
        dist = _process_group()
        self.rank = dist.get_rank() if dist is not None else 0
        disable_tf32()
        self.config = config or Config()
        cfg = self.config
        self.module, self.spec = get_model(cfg.model, dtype=cfg.torch_dtype(), **(cfg.model_kwargs or {}))
        pre_up = self.spec.pre_upscaled_input
        # the training degradation factor: the net's own scale, or for
        # pre-upscaled-input refiners (net_scale 1) the serving x``scalemulti``
        scale = cfg.scalemulti if pre_up else self.spec.net_scale
        self.train_scale = scale

        if train_images is None:
            log.warning("no training images provided; using synthetic smoke set")
            train_images = synthetic_images(8, max(128, cfg.lr_patch * scale + 8))
        if val_images is None:
            val_images = train_images[:2]

        hr_patch = cfg.lr_patch * scale
        # each process samples its own part of the global batch (a seed of its own)
        proc = self.rank if dist is not None and dist.get_world_size() > 1 else 0
        self.sampler = PatchSampler(train_images, hr_patch=hr_patch, batch_size=cfg.batch_size,
                                    seed=cfg.seed + 7919 * proc, augment=cfg.augment, weights=train_weights,
                                    moa=cfg.moa)
        self.val_sampler = PatchSampler(val_images, hr_patch=hr_patch, batch_size=cfg.batch_size,
                                        seed=cfg.seed + 1 + 7919 * proc)

        if cfg.lr_schedule == "cosine":
            lr = cosine_decay_schedule(cfg.lr, max(cfg.epochs * cfg.steps_per_epoch, 1), alpha=0.05)
        else:
            lr = cfg.lr
        self.module.to(self.device)
        if params is not None:
            load_params(self.module, params)
        else:
            init_params(self.module, cfg.seed)
        opt = Adam(mask_frozen(self.module), lr, b1=cfg.beta1, clip_norm=cfg.clip_norm)
        ema = None
        if cfg.ema_decay > 0.0:
            ema = {_path(k): p.detach().clone() for k, p in self.module.named_parameters()}
        self.state = TrainState(self.module, opt, 0, ema)
        self.train_step = make_train_step(scale, cfg.blur_sigma, pre_up, ema_decay=cfg.ema_decay, loss=cfg.loss,
                                          charbonnier_eps=cfg.charbonnier_eps)
        self.eval_step = make_eval_step(scale, cfg.blur_sigma, pre_up)
        if mesh is not None:
            from image_enhance_keras_tpu_torch.parallel.data_parallel import shard_eval_step, shard_train_step

            self.train_step = shard_train_step(self.train_step, mesh)
            self.eval_step = shard_eval_step(self.eval_step, mesh)

        # the full-image metric gate (the scorpath protocol), per epoch on
        # the val frames cropped to a multiple of the scale
        monitor = cfg.monitor
        self._image_metric_step = None
        self.metric_images: list[np.ndarray] = []
        if monitor in ("val_ssim_y", "val_psnr_y") or cfg.image_eval:
            self._image_metric_step = make_image_metric_step(scale, pre_up)
            for im in val_images:
                h = (im.shape[0] // scale) * scale
                w = (im.shape[1] // scale) * scale
                if h >= 44 and w >= 44:  # crop-10 must leave pixels
                    self.metric_images.append(np.asarray(im[:h, :w]))
            if not self.metric_images and monitor in ("val_ssim_y", "val_psnr_y"):
                log.warning("monitor=%s but no val image is >=44px after /4 crop; falling back to val_psnr",
                            monitor)
                monitor = "val_psnr"
        # loss-like monitors minimise; psnr and ssim maximise
        mode = "min" if monitor.endswith("loss") else "max"
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, monitor=monitor, mode=mode)
        self.history = HistoryLogger(f"{cfg.checkpoint_dir}/history.json", write=self.rank == 0)

    def _eval_forward(self, device: torch.device | None = None) -> Callable[[torch.Tensor], torch.Tensor]:
        """The forward the val metrics and the best-checkpoint gate score:
        on the EMA shadow when enabled (the weights that would be served),
        else on the module's own parameters; on ``device`` (a mesh's other
        device: the module's replica there) when given."""
        module = self.module
        if device is not None and self.mesh is not None:
            module = self.train_step.replicas.on(self.module, device)
        if self.state.ema is None:
            return module
        dev = next(module.parameters()).device
        ema = {k.replace("/", "."): v.to(dev) for k, v in self.state.ema.items()}
        return lambda x: torch.func.functional_call(module, ema, (x,))

    def _batch(self, batch_np: np.ndarray) -> torch.Tensor:
        """A host batch for the steps: on the state's device, or on the host
        for the data-parallel step, which sends each shard to its device."""
        return torch.tensor(batch_np, device="cpu" if self.mesh is not None else self.device)

    def _image_metrics(self) -> dict[str, float]:
        if self._image_metric_step is None or not self.metric_images:
            return {}
        forward = self._eval_forward()
        vals = [self._image_metric_step(forward, self._batch(im)) for im in self.metric_images]
        return {k: float(np.mean([float(v[k]) for v in vals])) for k in vals[0]}

    # ------------------------------------------------------------------
    def resume(self) -> bool:
        restored = self.ckpt.restore_latest()
        if restored is None:
            return False
        self.state.load_state_dict(restored)
        if self.mesh is not None:
            self.train_step.replicas.sync(self.module)
        log.info("resumed from step %s", self.state.step)
        return True

    def fit(self, epochs: int | None = None, steps_per_epoch: int | None = None, val_steps: int = 4) -> dict:
        cfg = self.config
        epochs = epochs or cfg.epochs
        steps_per_epoch = steps_per_epoch or cfg.steps_per_epoch
        if cfg.lr_schedule == "cosine" and epochs * steps_per_epoch != max(cfg.epochs * cfg.steps_per_epoch, 1):
            log.warning(
                "cosine schedule was built for %d total steps but fit() will run %d; later steps train at "
                "the decayed floor (rebuild the Trainer with matching epochs/steps_per_epoch to re-span it)",
                max(cfg.epochs * cfg.steps_per_epoch, 1), epochs * steps_per_epoch,
            )
        # a resumed state continues the epoch numbering (resume() restored
        # the step): restarting at 1 would duplicate history and index labels
        start_epoch = self.state.step // max(steps_per_epoch, 1)
        if start_epoch >= epochs:
            log.info("resume: %d epochs already trained (budget %d); nothing to do", start_epoch, epochs)
            return self.history.as_dict()
        for epoch in range(start_epoch + 1, epochs + 1):
            t0 = time.time()
            losses, psnrs = [], []
            for _ in range(steps_per_epoch):
                self.state, metrics = self.train_step(self.state, self._batch(self.sampler.sample()))
                losses.append(metrics["loss"])
                psnrs.append(metrics["psnr"])
            forward = self._eval_forward if self.mesh is not None else self._eval_forward()
            vals = [self.eval_step(forward, self._batch(self.val_sampler.sample())) for _ in range(val_steps)]
            val = {k: float(np.mean([float(v[k]) for v in vals])) for k in vals[0]}
            val.update(self._image_metrics())
            epoch_metrics = {
                "loss": float(np.mean([float(x) for x in losses])),
                "psnr": float(np.mean([float(x) for x in psnrs])),
                **val,
                "sec": time.time() - t0,
            }
            # checkpoint cadence: every cfg.ckpt_every epochs and the final one
            is_best = False
            if (epoch % max(cfg.ckpt_every, 1) == 0 or epoch == epochs) and self.rank == 0:
                is_best = self.ckpt.save_epoch(self.state.state_dict(), epoch, epoch_metrics)
                if self.state.ema is not None:
                    # the serving artifact of the EMA weights the gate scored
                    # (load_weights on latest/ or best/ yields the raw params)
                    export_params_npz(f"{cfg.checkpoint_dir}/latest_ema.npz", self.state.ema)
                    if is_best:
                        export_params_npz(f"{cfg.checkpoint_dir}/best_ema.npz", self.state.ema)
            dist = _process_group()
            if dist is not None:
                dist.barrier()  # rank 0's checkpoint is written before any rank reads it
            self.history.log_epoch(epoch, epoch_metrics)
            log.info(
                "epoch %d/%d loss %.5f psnr %.2f val_psnr %.2f (%.1fs)%s",
                epoch, epochs, epoch_metrics["loss"], epoch_metrics["psnr"],
                epoch_metrics.get("val_psnr", float("nan")), epoch_metrics["sec"],
                " *best*" if is_best else "",
            )
        return self.history.as_dict()
