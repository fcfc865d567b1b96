"""Kernels of the port: CUDA sources in ``csrc/``, wrappers beside them."""
