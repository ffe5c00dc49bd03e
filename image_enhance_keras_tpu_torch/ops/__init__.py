"""Tensor ops: resizes, color transforms, filters, pixel-shuffle, metrics, and the CUDA kernels (``ops/cuda``)."""

from image_enhance_keras_tpu_torch.ops.resize import (  # noqa: F401
    resize2d,
    resize_bilinear_tf1,
    resize_bicubic_pil,
    upscale_bilinear_x4,
)
from image_enhance_keras_tpu_torch.ops.color import (  # noqa: F401
    rgb2ycbcr,
    ycbcr2rgb,
    rgb2y,
    im2double,
)
from image_enhance_keras_tpu_torch.ops.filters import (  # noqa: F401
    gaussian_blur,
    uniform_filter,
    sharpen_pil,
)
from image_enhance_keras_tpu_torch.ops.pixel_shuffle import (  # noqa: F401
    depth_to_space,
    space_to_depth,
)
from image_enhance_keras_tpu_torch.ops.metrics import (  # noqa: F401
    psnr_nitre,
    psnr_vdsr,
    psnr_shave,
    psnr_peak1,
    ssim,
)
