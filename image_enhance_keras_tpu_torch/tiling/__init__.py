"""Overlapped tiling: plan, extract, crop-stitch, shifted grids, dense patches."""

from image_enhance_keras_tpu_torch.tiling.tiles import (  # noqa: F401
    TilePlan,
    plan_tiles,
    pad_to_plan,
    extract_tiles,
    stitch_tiles,
    crop_output,
    shift_grid_axis,
    shifted_extract_indices,
    shifted_stitch_indices,
    gather_tiles_2d,
    scatter_tiles_2d,
)
from image_enhance_keras_tpu_torch.tiling.dense import (  # noqa: F401
    extract_dense_patches,
    reconstruct_average,
)
