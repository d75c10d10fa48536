"""Hand-written CUDA kernels (``csrc/*.cu``) and their plain torch versions.

Nothing here imports or builds a kernel at import time: a library is built
with nvcc and loaded with ctypes on the first launch (``build.load``).
"""
