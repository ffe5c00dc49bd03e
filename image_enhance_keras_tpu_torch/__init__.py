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
-m image_enhance_keras_tpu_torch`` is the front door; ``parallel/`` shards
inference and training over several devices (``ShardedResolver``,
``Trainer(mesh=)``); ``compat`` is the reference-named surface for users
of the original Keras repo.  Nothing here imports JAX.
"""

__version__ = "0.1.0"

_LAZY = {
    "SuperResolver": ("image_enhance_keras_tpu_torch.engine", "SuperResolver"),
    "ShardedResolver": ("image_enhance_keras_tpu_torch.parallel", "ShardedResolver"),
    "Trainer": ("image_enhance_keras_tpu_torch.train.trainer", "Trainer"),
    "Config": ("image_enhance_keras_tpu_torch.utils.config", "Config"),
    "compat": ("image_enhance_keras_tpu_torch.compat", None),
}


def __getattr__(name):
    """Lazy top-level exports: ``from image_enhance_keras_tpu_torch import
    ShardedResolver`` without importing the engine for users of the ops alone."""
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(name)
    import importlib

    mod = importlib.import_module(entry[0])
    return getattr(mod, entry[1]) if entry[1] else mod
