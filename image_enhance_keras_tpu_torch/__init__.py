"""PyTorch/CUDA port of ``image_enhance_keras_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package so each port module sits at the same
relative path as its reference.  This slice runs the didbl x4 generator in
float32 through ``cli.main_dirpath`` (``--forward xla`` or ``pallas``); the
Light53 and Light residual blocks of the ``pallas`` forward run on
hand-written CUDA kernels (``csrc/blocks.cu``).  Nothing here imports JAX.
"""

__version__ = "0.1.0"
