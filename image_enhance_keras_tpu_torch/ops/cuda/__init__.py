"""Hand-written CUDA kernels (``csrc/*.cu``), built with nvcc and bound with ctypes."""
