"""PyTorch/CUDA port of ``image_enhance_keras_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package so each port module sits at the same
relative path as its reference.  It runs the didbl x4 generator through
``cli.main_dirpath``: ``--forward xla`` (plain torch), ``pallas`` (the
float32 Light53 and Light blocks on hand-written CUDA kernels,
``csrc/blocks.cu``), ``pallas_chain`` (the same blocks as two chain
kernels, ``csrc/tower.cu``) and ``pallas_int8`` (every residual block on
int8 CUDA kernels, ``csrc/int8_blocks.cu``, the x4 on ``csrc/upsample.cu``),
scores outputs with ``cli.scorpath`` (PSNR-Y / SSIM-Y, NTIRE protocol),
trains every zoo model with ``cli.learn`` (``train/trainer.py``), serves
directories through ``runtime/serving.py`` (``main_dirpath --pipeline``)
and exports serving programs (``cli.export_model``, ``runtime/export.py``,
every kernel a ``torch.library`` op of ``ops/cuda/library.py``); ``python
-m image_enhance_keras_tpu_torch`` is the front door.  Nothing here imports
JAX.
"""

__version__ = "0.1.0"
