"""Drop-in compatibility surface for users of the reference repo (mirror of ``compat.py``).

The reference's public names (img_utils.py / PSNR.py / models.py call
sites) on top of the port, so scripts written against
``diacaf/image-enhance-keras`` can switch imports and run:

    from image_enhance_keras_tpu_torch import compat as img_utils
    patches, grid = img_utils.extract_patches_Step(img, (96, 96), 64)

Functions return NumPy arrays (the reference's contract).  The array
helpers (tiling, PSNR, resizes, adjustments) take and give host arrays and
compute on the CPU; ``DifvdsrDouble`` and ``transform_images`` run the
model and the data pipeline on ``device`` ("cuda" unless the caller passes
``device="cpu"``).  New code should use the first-class APIs
(``engine.SuperResolver``, ``tiling``, ``ops.metrics``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from image_enhance_keras_tpu_torch.ops import metrics as _metrics
from image_enhance_keras_tpu_torch.ops.color import rgb2ycbcr as _rgb2ycbcr
from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8
from image_enhance_keras_tpu_torch.tiling import dense as _dense
from image_enhance_keras_tpu_torch.tiling import tiles as _tiles
from image_enhance_keras_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

__all__ = [
    "extract_patches_Step",
    "rebuild_from_patches_Step",
    "make_patches",
    "combine_patches",
    "extract_patches_2dlocal",
    "reconstruct_from_patches_2dlocal",
    "PSNRLoss",
    "PSNRLossTest",
    "_image_scale_multiplier",
    "img_size",
    "stride",
    "psnrNITRE",
    "psnrVDSR",
    "PSNRTorch",
    "psnrSVLAB",
    "psnr",
    "psnr2",
    "psnr3",
    "im2double",
    "im2doubleZ",
    "rgb2y",
    "imresize_bicubic",
    "SetGama",
    "SetContrast",
    "smooth_gan_labels",
    "subimage_build_patch_global",
    "subimage_combine_patches_global",
    "subimage_patch",
    "make_patchesOrig",
    "make_patchesStep",
    "extract_patches_2dv2",
    "transform_images",
    "image_count",
    "image_generator",
    "DifvdsrDouble",
]


def _f32(a) -> torch.Tensor:
    """A host array as a float32 CPU tensor (JAX's default float width)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


# ---------------------------------------------------------------------------
# img_utils.py surface (tiling)
# ---------------------------------------------------------------------------

def extract_patches_Step(image, patch_size, step_patches=24):
    """Reference img_utils.py:601-690 contract: overlapping tiles from an
    (already padded) image, column-major order, plus the (cnt_h, cnt_w) grid."""
    image = np.asarray(image)
    p_h, p_w = patch_size
    if p_h != p_w:
        raise ValueError("square patches only (reference always uses square)")
    h, w = image.shape[:2]
    cnt_h = _tiles._count_positions(h, p_h, step_patches)
    cnt_w = _tiles._count_positions(w, p_w, step_patches)
    plan = _tiles.TilePlan(orig_h=h, orig_w=w, padded_h=h, padded_w=w, patch=p_h, step=step_patches,
                           cnt_h=cnt_h, cnt_w=cnt_w, scale=1, crop=0)
    return _tiles.extract_tiles(_f32(image), plan).numpy(), (cnt_h, cnt_w)


def rebuild_from_patches_Step(img_initial, patches, patch_size, tupleinit, scale, step_patches_ini=24):
    """Reference img_utils.py:692-724 contract: overwrite-order crop-stitch
    (8-px borders except first row/col) onto a (H*scale, W*scale, 3) canvas."""
    h, w = np.asarray(img_initial).shape[:2]
    cnt_h, cnt_w = tupleinit
    plan = _tiles.TilePlan(orig_h=h, orig_w=w, padded_h=h, padded_w=w, patch=patch_size[0],
                           step=step_patches_ini, cnt_h=cnt_h, cnt_w=cnt_w, scale=scale, crop=8)
    return _tiles.stitch_tiles(_f32(patches), plan).numpy()


def make_patches(x, scale, patch_size, upscale=True, verbose=1):
    """Dense sliding-window patches (reference img_utils.py:159-172);
    ``scale`` and ``upscale`` are inert, as in the reference (its pre-upscale
    is commented out)."""
    return _dense.extract_dense_patches(_f32(x), patch_size, 1).numpy()


def combine_patches(in_patches, out_shape, scale):
    """Overlap-average reconstruction (reference img_utils.py:189-196)."""
    return _dense.reconstruct_average(_f32(in_patches), out_shape[:2], step=1, pad=0).numpy()


def extract_patches_2dlocal(image, imagesfull, patch_size, step=16):
    """Stride-filtered dense grid (reference img_utils.py:513-556)."""
    return _dense.extract_dense_patches(_f32(image), patch_size[0], step).numpy()


def reconstruct_from_patches_2dlocal(imagesfull, patches, image_size, step=16):
    """Overlap-average with 4-px interior trim (reference img_utils.py:442-511)."""
    return _dense.reconstruct_average(_f32(patches), image_size[:2], step=step, pad=4).numpy()


# ---------------------------------------------------------------------------
# PSNR.py surface
# ---------------------------------------------------------------------------

def psnrNITRE(pred, gt, shave_border=0):
    return float(_metrics.psnr_nitre(_f32(pred), _f32(gt), shave_border))


def psnrVDSR(target, ref, scale):
    return float(_metrics.psnr_vdsr(_f32(target), _f32(ref), scale))


def PSNRTorch(pred, gt, shave_border=0):
    return float(_metrics.psnr_shave(_f32(pred), _f32(gt), shave_border))


def psnrSVLAB(img1, img2):
    return float(_metrics.psnr_peak1(_f32(img1), _f32(img2)))


def im2double(im):
    return np.asarray(im, np.float64) / 255.0


def im2doubleZ(im):
    """Min-max normalisation (reference PSNR.py:87-91)."""
    im = np.asarray(im)
    lo, hi = im.min(), im.max()
    return (im.astype(float) - lo) / (hi - lo)


def PSNRLoss(y_true, y_pred):
    """The reference's training metric (models.py:43-55): a stub that returns
    mean(y_pred), kept as it is (the real formula sits dead after its return)."""
    return float(np.mean(np.asarray(y_pred)))


def PSNRLossTest(y_true, y_pred):
    """models.py:57-69: the real -10*log10(MSE) on unit-range tensors."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float(-10.0 * np.log10(np.mean(np.square(y_pred - y_true))))


#: module config constants (img_utils.py:21-42), kept for reference scripts that read them
_image_scale_multiplier = 1
img_size = 256 * _image_scale_multiplier
stride = 16 * _image_scale_multiplier


def psnr(y_true, y_pred):
    """models.py:71-76 (unit-range MSE form)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    assert y_true.shape == y_pred.shape
    return -10.0 * np.log10(np.mean(np.square(y_pred - y_true)))


def psnr2(img1, img2):
    """models.py:78-83 (255-peak, 20*log10(255/rms))."""
    mse = np.mean((np.asarray(img1, float) - np.asarray(img2, float)) ** 2)
    if mse == 0:
        return 100
    return 20 * np.log10(255.0 / np.sqrt(mse))


def psnr3(img1, img2):
    """models.py:85-90 (the reference's 255^2/sqrt(mse) variant, its sqrt kept)."""
    mse = np.mean((np.asarray(img1, float) - np.asarray(img2, float)) ** 2)
    if mse == 0:
        return 100
    return 10 * np.log10(255.0 ** 2 / np.sqrt(mse))


def rgb2y(img):
    """The reference's rgb2y (PSNR.py:101-109), fixed: the Y of YCbCr."""
    return _rgb2ycbcr(_f32(img)).numpy()[..., 0]


def imresize_bicubic(img, size):
    """scipy.misc.imresize(..., interp='bicubic') stand-in (uint8 semantics)."""
    return resize_pil_uint8(_f32(img), tuple(size)).numpy().astype(np.uint8)


# ---------------------------------------------------------------------------
# pixel-adjust + misc utilities (img_utils.py:401-440)
# ---------------------------------------------------------------------------

def SetGama(imgParam, gamma=0.1):
    """Gamma adjust (img_utils.py:415-427; the exponent is 1/gamma there),
    truncated like the reference's uint8 assignment."""
    im = np.asarray(imgParam, np.float32)
    out = 255.0 * np.clip(im / 255.0, 0.0, 1.0) ** (1.0 / gamma)
    return np.clip(out, 0, 255).astype(np.uint8)


def SetContrast(im, contrast=128):
    """Linear contrast about 128 with the 259-formula factor (img_utils.py:429-440)."""
    factor = (259.0 * (contrast + 255.0)) / (255.0 * (259.0 - contrast))
    out = factor * (np.asarray(im, np.float32) - 128.0) + 128.0
    return np.clip(out, 0, 255).astype(np.uint8)


def smooth_gan_labels(y):
    """GAN label smoothing (img_utils.py:401-413): 0 -> U[0,0.3), 1 -> U[0.7,1.2)."""
    y = np.asarray(y, int)
    assert y.ndim == 2, "Needs to be a binary class"
    lo = np.random.uniform(0.0, 0.3, y.shape)
    hi = np.random.uniform(0.7, 1.2, y.shape)
    return np.where(y == 0, lo, hi).astype(np.float32)


def _grid(h, w, stride, patch_size):
    """The reference's grid (img_utils.py:240-287), its swapped width/height bound check kept."""
    return [(y, x) for y in range(0, w, stride) for x in range(0, h, stride)
            if (x + patch_size) < w and (y + patch_size) < h]


def subimage_build_patch_global(img, stride, patch_size, nb_hr_images=None):
    """Grid patch extraction (img_utils.py:240-261), in the reference's order."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    return np.stack([img[y : y + patch_size, x : x + patch_size, :]
                     for y, x in _grid(h, w, stride, patch_size)]).astype(float)


def subimage_patch(img, stride, patch_size, nb_hr_images=None):
    """Generator form of the grid extraction (img_utils.py:144-157)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    for y, x in _grid(h, w, stride, patch_size):
        yield img[y : y + patch_size, x : x + patch_size, :]


def subimage_combine_patches_global(imgtrue, patches, stride, patch_size, scale):
    """Grid paste onto the bicubic-upscaled image (img_utils.py:268-287)."""
    imgtrue = np.asarray(imgtrue)
    ht, wt = imgtrue.shape[:2]
    img = np.asarray(imresize_bicubic(imgtrue, (ht * scale, wt * scale)), np.float64)
    h, w = img.shape[:2]
    grid = _grid(h, w, stride, patch_size)
    if len(grid) > len(patches):
        # the reference would IndexError here (it walks the scaled canvas with
        # the unscaled grid): the patches must come from the scaled image
        raise ValueError(
            f"subimage_combine_patches_global: the x{scale} canvas grid has {len(grid)} positions but "
            f"only {len(patches)} patches were given (build the patches from the scaled image)"
        )
    for j, (y, x) in enumerate(grid):
        img[y : y + patch_size, x : x + patch_size, :] = patches[j]
    return img


def make_patchesOrig(x, scale, patch_size, upscale=False, verbose=1):
    """Dense sliding-window patches (img_utils.py:174-180)."""
    return make_patches(x, scale, patch_size, upscale, verbose)


def make_patchesStep(x, scale, patch_size, upscale=False, extraction_step=24, verbose=1):
    """Strided dense patches (img_utils.py:182-187)."""
    return _dense.extract_dense_patches(_f32(x), patch_size, extraction_step).numpy()


def extract_patches_2dv2(image, patch_size, max_patches=None, random_state=None):
    """Vendored-sklearn dense extraction (img_utils.py:561-599; uint8):
    rectangular patch sizes, ``max_patches`` (an int count or a (0, 1)
    fraction) sampled at uniform-random positions with ``random_state``."""
    from numpy.lib.stride_tricks import sliding_window_view

    img = np.asarray(image)
    p_h, p_w = int(patch_size[0]), int(patch_size[1])
    i_h, i_w = img.shape[:2]
    n_h, n_w = i_h - p_h + 1, i_w - p_w + 1
    if n_h <= 0 or n_w <= 0:
        raise ValueError(f"patch_size {p_h}x{p_w} exceeds image size {i_h}x{i_w}")
    if max_patches is not None:
        n = int(max_patches * n_h * n_w) if 0 < max_patches < 1 else int(max_patches)
        rng = random_state if isinstance(random_state, np.random.RandomState) else np.random.RandomState(random_state)
        rows = rng.randint(0, n_h, n)
        cols = rng.randint(0, n_w, n)
        return np.stack([img[r : r + p_h, c : c + p_w] for r, c in zip(rows, cols)]).astype(np.uint8)
    win = sliding_window_view(img, (p_h, p_w), axis=(0, 1))
    if img.ndim == 3:  # (n_h, n_w, C, p_h, p_w) -> (n_h, n_w, p_h, p_w, C)
        win = np.moveaxis(win, 2, -1)
    return win.reshape(-1, p_h, p_w, *img.shape[2:]).astype(np.uint8)


def transform_images(directory, output_directory, scaling_factor=2, max_nb_images=-1, true_upscale=False,
                     device="cuda"):
    """Dataset preparation (img_utils.py:44-123) on the port's
    ``prepare_data`` pipeline (sharpen + blur + bicubic pairs), on ``device``.

    ``max_nb_images`` keeps the reference's stop condition (img_utils.py:
    119-121): the index starts at 1, increments after each image, and the
    loop breaks once it reaches ``max_nb_images``, so N > 0 processes
    ``max(1, N - 1)`` images; 0, negative or None process all of them."""
    from image_enhance_keras_tpu_torch.cli.prepare_data import prepare

    cap = None
    if max_nb_images is not None and int(max_nb_images) > 0:
        cap = max(1, int(max_nb_images) - 1)
    return prepare(directory, output_directory, scale=scaling_factor, true_upscale=true_upscale,
                   max_images=cap, device=device)


# ---------------------------------------------------------------------------
# training-data surface
# ---------------------------------------------------------------------------

def image_count(dir_path: str = "train_images/train") -> int:
    from image_enhance_keras_tpu_torch.data.generator import image_count as _ic

    return _ic(dir_path)


def image_generator(directory, scale_factor=2, target_shape=None, channels=3, small_train_images=False,
                    shuffle=True, batch_size=32, seed=None, **_):
    """Disk-pair batch generator with the reference's shape contract
    (img_utils.py:290-372), tf dim-ordering:

    * default: X and y both ``16*scale_factor*multiplier`` px (the
      pre-upscaled X pairing, img_utils.py:303-309);
    * ``small_train_images``: X resized to ``16*multiplier`` px at load
      (img_utils.py:352), y ``16*scale_factor*multiplier`` px;
    * ``target_shape``: y is target_shape; X is target_shape (or
      ``target_shape*multiplier//scale_factor`` with small_train_images).

    Patches on disk that do not fit raise ValueError, as the reference's
    fixed-shape ``batch_x[i] = img`` assignment would."""
    from image_enhance_keras_tpu_torch.data.generator import paired_patch_generator

    m = _image_scale_multiplier
    if target_shape is None:
        if small_train_images:
            x_shape = (16 * m, 16 * m, channels)
            y_shape = (16 * scale_factor * m, 16 * scale_factor * m, channels)
        else:
            x_shape = (16 * scale_factor * m, 16 * scale_factor * m, channels)
            y_shape = x_shape
    elif small_train_images:
        y_shape = tuple(target_shape) + (channels,)
        x_shape = (target_shape[0] * m // scale_factor, target_shape[1] * m // scale_factor, channels)
    else:
        x_shape = tuple(target_shape) + (channels,)
        y_shape = x_shape

    for bx, by in paired_patch_generator(directory, batch_size=batch_size, shuffle=shuffle, seed=seed):
        if small_train_images and bx.shape[1:3] != x_shape[:2]:
            # the reference resizes every X to the LR size at load time
            bx = resize_pil_uint8(_f32(bx * 255.0), x_shape[:2]).numpy().astype(np.float32) / 255.0
        if bx.shape[1:] != x_shape or by.shape[1:] != y_shape:
            raise ValueError(
                f"image_generator: on-disk patches {bx.shape[1:]}/{by.shape[1:]} do not fit the "
                f"scale_factor={scale_factor} small_train_images={small_train_images} contract "
                f"{x_shape}/{y_shape} (img_utils.py:303-329)"
            )
        yield bx, by


# ---------------------------------------------------------------------------
# models.py surface
# ---------------------------------------------------------------------------

class DifvdsrDouble:
    """The reference's flagship model class (models.py:1146) on the port:
    create_model / load -> ``SuperResolver``; upscaleStepPatch -> the tiled
    pipeline; upVideo -> the whole frame; fit -> ``Trainer``.  Runs on
    ``device`` ("cuda" unless the caller passes "cpu")."""

    #: checkpoint search order: a complete locally trained checkpoint of the
    #: port's trainer ("best", holding its state file) first, then the
    #: committed demo checkpoint of the zoo's registry.  As the reference
    #: (whose load_weights is hard-coded, models.py:1217-1218), a missing
    #: checkpoint fails loudly: random-init weights are never served.
    WEIGHT_CANDIDATES = ("weights_Double/best",)

    def __init__(self, scale_factor: int = 1, device: str | torch.device = "cuda"):
        self.scale_factor = scale_factor
        self.device = device
        self.weight_path = self._find_weights()
        # create_model re-resolves at load time unless the caller set
        # .weight_path: a checkpoint trained after construction wins over the demo npz
        self._auto_weight_path = self.weight_path
        self._resolver = None

    @classmethod
    def _find_weights(cls):
        from image_enhance_keras_tpu_torch.models import zoo
        from image_enhance_keras_tpu_torch.train.checkpoints import STATE_FILE
        from image_enhance_keras_tpu_torch.utils.paths import find_repo_asset

        for rel in cls.WEIGHT_CANDIDATES:
            cand = find_repo_asset(rel)  # CWD first, then the checkout
            if cand is None:
                continue
            # a checkpoint directory must be a complete save of the port's
            # trainer: an orbax one, or an interrupted save, is passed over
            # for the loadable committed npz beside it
            if os.path.isdir(cand) and not os.path.isfile(os.path.join(cand, STATE_FILE)):
                log.warning("skipping checkpoint directory %r (no %s); falling through the candidate list",
                            cand, STATE_FILE)
                continue
            return cand
        default = zoo.resolve_default_weights(zoo.MODEL_REGISTRY["didbl"])
        if default is not None:
            return default
        return cls.WEIGHT_CANDIDATES[0]  # named in create_model's error

    def create_model(self, height=32, width=32, channels=3, load_weights=False, batch_size=128):
        from image_enhance_keras_tpu_torch import engine

        if load_weights and self.weight_path == getattr(self, "_auto_weight_path", None):
            self.weight_path = self._auto_weight_path = self._find_weights()
        if load_weights and not os.path.exists(self.weight_path):
            raise FileNotFoundError(
                f"checkpoint {self.weight_path!r} not found (searched {list(self.WEIGHT_CANDIDATES)}); refusing "
                "to serve random-init weights.  Train one (cli.learn) or set .weight_path to a Keras .h5, "
                "a params .npz or a checkpoint directory of the port's trainer."
            )
        weights = self.weight_path if load_weights else None
        if load_weights:
            log.info("serving weights from %r", weights)
        self._resolver = engine.SuperResolver(model="didbl", weights=weights, device=self.device)
        return self._resolver

    def _ensure(self, load_weights=True):
        if self._resolver is None:
            self.create_model(load_weights=load_weights)
        return self._resolver

    def upscaleStepPatch(self, img_path, save_intermediate=False, return_image=False, suffix="scaled",
                         patch_size=96, scalemulti=4, step_patch=64, mode="patch", verbose=True):
        """The tiled pipeline on one file (models.py:184-208); a geometry
        other than the resolver's retargets it."""
        r = self._ensure()
        if (patch_size, step_patch, scalemulti, mode) != (r.patch, r.step, r.scalemulti, r.mode):
            r.patch, r.step = patch_size, step_patch
            r.scalemulti, r.mode = scalemulti, mode
            r.tile_chunk = max(1, 16 * (96 * 96) // (patch_size * patch_size))
        if return_image:
            from image_enhance_keras_tpu_torch.data.io import imread

            return r.upscale(imread(img_path))
        return r.upscale_file(img_path, suffix=suffix, scale_label=self.scale_factor,
                              save_intermediate=save_intermediate)

    def upVideo(self, img_obj):
        return self._ensure().upscale_frame(np.asarray(img_obj))

    def _write_named(self, img_path, out, suffix):
        from image_enhance_keras_tpu_torch.data.io import imwrite
        from image_enhance_keras_tpu_torch.engine import output_name

        dst = output_name(img_path, suffix=suffix, scale_label=self.scale_factor)
        imwrite(dst, out)
        return dst

    @staticmethod
    def _write_intermediate(img_path, arr):
        from image_enhance_keras_tpu_torch.data.io import imwrite

        stem, ext = os.path.splitext(img_path)
        imwrite(stem + "_intermediate_" + ext, np.clip(np.round(arr), 0, 255).astype(np.uint8))

    def upscalePatch(self, img_path, save_intermediate=False, return_image=False, suffix="scaled",
                     patch_size=32, scalemulti=4, mode="patch", verbose=True):
        """Dense-patch alternative path (models.py:419-604): overlapping
        patches at step 4, each bicubic-downsampled by ``scalemulti``
        (models.py:499-508), reconstructed and overlap-averaged back (a
        same-size pass); mode='fast' runs the whole-frame x4 forward instead.
        ``save_intermediate`` writes the first downsampled patch to
        ``<stem>_intermediate_<ext>`` (models.py:525-530)."""
        from image_enhance_keras_tpu_torch.data.io import imread

        r = self._ensure()
        net_scale = r.spec.net_scale
        if mode == "patch" and int(scalemulti) != int(net_scale):
            # the reference ties the downsample factor to the network's scale
            raise ValueError(
                f"upscalePatch: scalemulti={scalemulti} does not match the network scale ({net_scale}); "
                f"the dense-patch path downsamples each patch by the net scale (models.py:499-508)"
            )
        img = imread(img_path)
        if save_intermediate and mode == "patch":
            first = _f32(img)[:patch_size, :patch_size]
            self._write_intermediate(
                img_path, resize_pil_uint8(first, (patch_size // int(scalemulti),) * 2).numpy())
        out = r.upscale_patch_average(img, patch=patch_size, step=4) if mode == "patch" else r.upscale_frame(img)
        return out if return_image else self._write_named(img_path, out, suffix)

    def upscale(self, img_path, save_intermediate=False, return_image=False, suffix="scaled", patch_size=32,
                mode="patch", verbose=True):
        """Legacy whole-image / dense-patch mode (models.py:606-853):
        mode='patch' is the dense overlap-average at step 16, mode='fast' the
        full-image branch.  ``save_intermediate`` writes
        ``<stem>_intermediate_<ext>``: the first network-input patch of the
        pre-bicubic-x4 frame in patch mode, the frame itself in fast mode
        (models.py:763-770)."""
        from image_enhance_keras_tpu_torch.data.io import imread

        r = self._ensure()
        img = imread(img_path)
        if save_intermediate:
            if mode == "patch":
                # the legacy path's whole-frame bicubic x4 (models.py:652), its
                # first patch, downsampled /4 back to the net input
                up = resize_pil_uint8(_f32(img), (img.shape[0] * 4, img.shape[1] * 4))[:patch_size, :patch_size]
                inter = resize_pil_uint8(up, (patch_size // 4, patch_size // 4)).numpy()
            else:
                inter = np.asarray(img, np.float32)
            self._write_intermediate(img_path, inter)
        out = r.upscale_patch_average(img, patch=patch_size, step=16) if mode == "patch" else r.upscale_frame(img)
        return out if return_image else self._write_named(img_path, out, suffix)

    def fit(self, batch_size=10, nb_epochs=100, save_history=False, history_fn="ScaleGen History.txt"):
        """Reference fit contract (models.py:131-157): train from the patch
        directories transform_images wrote (train_images/train and
        train_images/validation; y/ holds the HR patches) on the port's
        ``Trainer``, which regenerates the LR side with the same blur and
        bicubic degradation.  ``save_history`` writes the HistoryCheckpoint
        text format (advanced.py:22-27: str(dict), read back with
        ast.literal_eval)."""
        from image_enhance_keras_tpu_torch.data.pipeline import load_image_dir
        from image_enhance_keras_tpu_torch.train.trainer import Trainer
        from image_enhance_keras_tpu_torch.utils.config import Config
        from image_enhance_keras_tpu_torch.utils.paths import find_repo_asset

        train_dir = find_repo_asset("train_images/train/y")
        val_dir = find_repo_asset("train_images/validation/y")
        train = load_image_dir(train_dir) if train_dir else []
        val = load_image_dir(val_dir) if val_dir else []
        if not train:
            raise FileNotFoundError(
                "fit(): no training patches under train_images/train/y: run transform_images(...) or "
                "cli.prepare_data first (the reference's fit reads the materialised patch dirs, "
                "models.py:131-157)"
            )
        hr = min(min(im.shape[:2]) for im in train)
        cfg = Config(model="didbl", batch_size=batch_size, epochs=nb_epochs, lr_patch=max(1, hr // 4),
                     checkpoint_dir="weights_Double")
        hist = Trainer(cfg, train_images=train, val_images=val or train[:2], device=self.device).fit()
        if save_history:
            with open(history_fn, "w") as f:
                f.write(str(hist))
        return hist

    def evaluate(self, val_dir="val_images/set5nitre"):
        """The reference's evaluate dispatch (models.py:159-163)."""
        from image_enhance_keras_tpu_torch.eval import evaluate_model

        return evaluate_model(self._ensure(), val_dir)
