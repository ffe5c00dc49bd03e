"""Tensor ops: TF1 resize (plain torch) and the CUDA block kernels."""
